"""Segmentation losses (PyTorch port of ``mopa_tpu/models/losses.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor,
                  class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Masked CE with ``F.cross_entropy`` semantics: the mean weighted by the
    per-class weights of the valid points.

    logits (N, C); labels (N,) integer (may be out of range where invalid);
    valid (N,) bool.
    """
    num_classes = logits.shape[-1]
    safe = labels.long().clamp(0, num_classes - 1)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[:, None])[:, 0]
    w = class_weights.float()[safe] if class_weights is not None \
        else torch.ones_like(nll)
    w = w * valid.float()
    return (nll * w).sum() / w.sum().clamp(min=1e-12)
