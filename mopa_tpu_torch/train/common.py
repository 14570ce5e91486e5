"""Batch decoding (PyTorch port of ``mopa_tpu/train/common.py::decode_batch``
for the keys of eval batches, of train batches, of the EMA teacher's
unaugmented view, of host-built plans and of the host VGI cat domain)."""

from __future__ import annotations

import numpy as np
import torch

_INT_KEYS = ("coords", "img_indices", "seg_label", "pseudo_label_2d",
             "pseudo_label_3d", "sam_mask", "ema_map", "ori_coords",
             "ori_img_indices", "hp_counts", "hp_inverse", "hp_ori_counts",
             "hp_ori_inverse", "cat_label", "hp_cat_counts", "hp_cat_inverse")

# Keys only the EMA teacher reads (its unaugmented inputs and their host-built
# plans); the student step never sees them.
EMA_ONLY_KEYS = ("ori_img", "ori_img_indices", "ori_coords", "ori_batch_idx",
                 "ori_point_valid", "ori_feats", "ema_map", "ori_num_points",
                 "ori_feats_ones")
EMA_ONLY_PREFIX = "hp_ori_"


def is_ema_key(key: str) -> bool:
    return key in EMA_ONLY_KEYS or key.startswith(EMA_ONLY_PREFIX)


def decode_batch(batch: dict, device) -> dict:
    """Copy a collated batch to ``device`` and widen it to compute dtypes.

    Accepts numpy arrays or tensors in the wire format: uint8 images
    (``img``, ``ori_img``) become float32 in [0, 1]; integer keys (the
    compact int16 ``inverse``/``counts`` of host plans and ``cat_label``
    among them) become int64; ``point_valid``/``ori_point_valid`` are
    rebuilt from ``num_points``/``ori_num_points`` when absent; an all-ones
    SCN feature column shipped as the (B, C) ``feats_ones``/
    ``ori_feats_ones`` marker is expanded; ``batch_idx``/``ori_batch_idx`` are derived from the (B, P)
    layout when absent. Keys starting with "_" stay on the host side and are
    dropped.
    """
    out = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else torch.as_tensor(v)
        out[k] = t.to(device, non_blocking=True)
    for k in ("img", "ori_img"):
        if k in out and out[k].dtype == torch.uint8:
            out[k] = out[k].float() / 255.0
    for k in _INT_KEYS:
        if k in out:
            out[k] = out[k].long()
    for pre in ("", "ori_"):
        feats, valid = pre + "feats", pre + "point_valid"
        if feats in out:
            out[feats] = out[feats].float()
        if valid not in out and pre + "num_points" in out \
                and pre + "img_indices" in out:
            p = out[pre + "img_indices"].shape[1]
            out[valid] = (torch.arange(p, device=device)[None, :]
                          < out[pre + "num_points"][:, None])
        if feats not in out and pre + "feats_ones" in out and valid in out:
            b, c = out[pre + "feats_ones"].shape
            p = out[valid].shape[1]
            out[feats] = torch.ones((b * p, c), device=device)
    if "point_valid" in out and "batch_idx" not in out:
        b, p = out["point_valid"].shape
        out["batch_idx"] = torch.arange(b, device=device).repeat_interleave(p)
    if "ori_point_valid" in out and "ori_batch_idx" not in out \
            and "ori_coords" in out:
        b, p = out["ori_point_valid"].shape
        out["ori_batch_idx"] = torch.arange(
            b, device=device).repeat_interleave(p)
    return out
