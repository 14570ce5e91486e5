"""2D -> 3D feature lifting (PyTorch port of ``mopa_tpu/ops/lifting.py``):
one batched gather of per-point pixel features; its gradient is autograd's
accumulation into the (B, H, W, C) map."""

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
    b, h, w, c = feat_map.shape
    p = img_indices.shape[1]
    rows = img_indices[..., 0].long().clamp(0, h - 1)
    cols = img_indices[..., 1].long().clamp(0, w - 1)
    # padding points read distinct pixels (masked below), not all (0, 0):
    # the gather's backward then meets no long run of one index
    pos = torch.arange(p, device=feat_map.device)[None, :] % (h * w)
    flat = torch.where(valid, rows * w + cols, pos)
    bidx = torch.arange(b, device=feat_map.device)[:, None]
    out = feat_map.reshape(b, h * w, c)[bidx, flat]
    return torch.where(valid[..., None], out, torch.zeros_like(out))
