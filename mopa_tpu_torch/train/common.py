"""Batch decoding (PyTorch port of ``mopa_tpu/train/common.py::decode_batch``
for the keys of eval batches and of pre-EMA train batches)."""

from __future__ import annotations

import numpy as np
import torch

_INT_KEYS = ("coords", "img_indices", "seg_label", "pseudo_label_2d",
             "pseudo_label_3d", "sam_mask")


def decode_batch(batch: dict, device) -> dict:
    """Copy a collated batch to ``device`` and widen it to compute dtypes.

    Accepts numpy arrays or tensors in the wire format: uint8 images become
    float32 in [0, 1]; integer keys become int64; ``point_valid`` is rebuilt
    from ``num_points`` when absent; an all-ones SCN feature column shipped as
    the (B, C) ``feats_ones`` marker is expanded; ``batch_idx`` is derived
    from the (B, P) layout when absent. Keys starting with "_" stay on the
    host side and are dropped.
    """
    out = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else torch.as_tensor(v)
        out[k] = t.to(device, non_blocking=True)
    if "img" in out and out["img"].dtype == torch.uint8:
        out["img"] = out["img"].float() / 255.0
    for k in _INT_KEYS:
        if k in out:
            out[k] = out[k].long()
    if "feats" in out:
        out["feats"] = out["feats"].float()
    if "point_valid" not in out and "num_points" in out \
            and "img_indices" in out:
        p = out["img_indices"].shape[1]
        out["point_valid"] = (torch.arange(p, device=device)[None, :]
                              < out["num_points"][:, None])
    if "feats" not in out and "feats_ones" in out and "point_valid" in out:
        b, c = out["feats_ones"].shape
        p = out["point_valid"].shape[1]
        out["feats"] = torch.ones((b * p, c), device=device)
    if "point_valid" in out and "batch_idx" not in out:
        b, p = out["point_valid"].shape
        out["batch_idx"] = torch.arange(b, device=device).repeat_interleave(p)
    return out
