"""Pseudo-label refinement on the device (PyTorch port of
``mopa_tpu/data/utils/refine_pseudo_labels.py::refine_pseudo_labels_jax``,
the form the EMA teacher runs)."""

from __future__ import annotations

import torch


def refine_pseudo_labels(probs: torch.Tensor, pseudo_label: torch.Tensor,
                         valid: torch.Tensor, num_classes: int
                         ) -> torch.Tensor:
    """Per class, drop the labels whose confidence is below
    min(class median, 0.9).

    probs (N,) confidences; pseudo_label (N,) integer; valid (N,) bool.
    The median of a class is taken over its valid points: the mean of the two
    middle ranks of its run in one sort by (label, confidence). A class with
    no valid point passes nothing to drop. Invalid points, and points whose
    label is outside [0, ``num_classes``), get -100, the label the
    pseudo-label loss ignores. Returns int64 (N,)."""
    probs = probs.float()
    labels = pseudo_label.long()
    n = probs.shape[0]
    sel = valid & (labels >= 0) & (labels < num_classes)
    key = torch.where(sel, labels, torch.full_like(labels, num_classes))
    # torch has no two-key sort: a stable sort by confidence, then a stable
    # sort by class keeps each class's run in confidence order
    by_prob = torch.sort(probs, stable=True).indices
    by_key = torch.sort(key[by_prob], stable=True).indices
    vals = probs[by_prob][by_key]
    counts = torch.bincount(key, minlength=num_classes + 1)[:num_classes]
    starts = torch.cumsum(counts, 0) - counts
    m = counts.clamp(min=1)
    lo = (starts + (m - 1) // 2).clamp(0, max(n - 1, 0))
    hi = (starts + m // 2).clamp(0, max(n - 1, 0))
    med = 0.5 * (vals[lo] + vals[hi])
    thresh = torch.where(counts > 0, med.clamp(max=0.9),
                         torch.full_like(med, -float("inf")))
    th = thresh[labels.clamp(0, num_classes - 1)]
    keep = sel & (probs >= th)
    return torch.where(keep, labels, torch.full_like(labels, -100))
