"""Training metric (PyTorch port of ``mopa_tpu/models/metric.py``)."""

from __future__ import annotations

import torch


def confusion_matrix(logits: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, C) int64 counts of the valid, labelled points: rows = ground
    truth, columns = the logits' argmax (``bincount(C * label + pred)``)."""
    pred = logits.argmax(dim=-1)
    ok = valid & (labels >= 0) & (labels < num_classes)
    n2 = num_classes * num_classes
    flat = labels.long().clamp(0, num_classes - 1) * num_classes + pred
    flat = torch.where(ok, flat, torch.full_like(flat, n2))  # dump bucket
    return torch.bincount(flat, minlength=n2 + 1)[:n2].reshape(
        num_classes, num_classes)
