"""Pseudo-label refinement (port of
``mopa_tpu/data/utils/refine_pseudo_labels.py``): on the device
(:func:`refine_pseudo_labels`, the port of ``refine_pseudo_labels_jax``,
which the EMA teacher runs) and on the host in numpy, as the datasets call
them on offline pseudo labels and SAM masks (:func:`refine_pseudo_labels_np`,
:func:`refine_sam_2Dlabels`, :func:`refine_sam_mask`)."""

from __future__ import annotations

import numpy as np
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


def refine_pseudo_labels_np(probs, pseudo_label, ignore_label=-100):
    """Per class present, set the labels whose confidence is below
    min(class median, 0.9) to ``ignore_label`` (host numpy; the JAX
    package's ``refine_pseudo_labels``)."""
    probs = np.asarray(probs)
    pseudo_label = np.asarray(pseudo_label).copy()
    for cls_idx in np.unique(pseudo_label):
        curr_idx = np.nonzero(pseudo_label == cls_idx)[0]
        thresh = min(float(np.median(probs[curr_idx])), 0.9)
        ignore = curr_idx[probs[curr_idx] < thresh]
        pseudo_label[ignore] = ignore_label
    return pseudo_label


def refine_sam_2Dlabels(probs, img_indices, sam_mask, max_area_thre=0.1):
    """Dense (H, W) int32 2D pseudo labels: the refined point labels at
    their pixels, then every SAM mask smaller than ``max_area_thre`` of the
    image labelled by the argmax of its points' summed probabilities."""
    probs = np.asarray(probs, np.float32).copy()
    img_indices = np.asarray(img_indices).astype(np.int64)
    sam_mask = np.asarray(sam_mask)
    h, w = sam_mask.shape
    full_probs = np.zeros((h, w, probs.shape[1]), np.float32)
    full_labels = np.full((h, w), -100, np.int32)

    refined = refine_pseudo_labels_np(probs.max(1),
                                      probs.argmax(1).astype(np.int32))
    probs[refined <= -100, :] = 0.0
    full_labels[img_indices[:, 0], img_indices[:, 1]] = refined
    full_probs[img_indices[:, 0], img_indices[:, 1], :] = probs

    area_cap = max_area_thre * h * w
    for mask_id in np.unique(sam_mask):
        m = sam_mask == mask_id
        if m.sum() >= area_cap:
            continue
        votes = full_probs[m].reshape(-1, probs.shape[1]).sum(0)
        full_labels[m] = int(votes.argmax())
    return full_labels


def refine_sam_mask(sam_mask, max_area_thre=0.1, max_h=None):
    """An int32 copy of ``sam_mask`` with masks covering at least
    ``max_area_thre`` of the image set to -100, and with ``max_h`` the rows
    above the bottom ``max_h`` (above the LiDAR's view) too."""
    sam_mask = np.asarray(sam_mask).astype(np.int32).copy()
    h, w = sam_mask.shape
    area_cap = max_area_thre * h * w
    ids, counts = np.unique(sam_mask, return_counts=True)
    for mask_id, cnt in zip(ids, counts):
        if cnt >= area_cap:
            sam_mask[sam_mask == mask_id] = -100
    if max_h is not None:
        sam_mask[: h - max_h, :] = -100
    return sam_mask
