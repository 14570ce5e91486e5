"""Training metrics (PyTorch port of ``mopa_tpu/models/metric.py``): the
confusion matrix a train step computes on the card, and ``SegIoU``, the
host-side accumulator the train loop logs."""

from __future__ import annotations

import numpy as np
import torch

from mopa_tpu_torch.common.spans import span


def confusion_matrix(logits: torch.Tensor, labels: torch.Tensor,
                     valid: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, C) int64 counts of the valid, labelled points: rows = ground
    truth, columns = the logits' argmax (``bincount(C * label + pred)``).
    On a card the bincount waits for the device twice (it reads the
    least and the largest value on the host): span ``sync/cm_bincount``."""
    pred = logits.argmax(dim=-1)
    ok = valid & (labels >= 0) & (labels < num_classes)
    n2 = num_classes * num_classes
    flat = labels.long().clamp(0, num_classes - 1) * num_classes + pred
    flat = torch.where(ok, flat, torch.full_like(flat, n2))  # dump bucket
    with span("sync/cm_bincount"):
        counts = torch.bincount(flat, minlength=n2 + 1)
    return counts[:n2].reshape(num_classes, num_classes)


class SegIoU:
    """Host-side accumulator of confusion matrices with the reference's
    meter interface (``mopa/models/metric.py:26-77``)."""

    def __init__(self, num_classes, ignore_index=-100, name="seg_iou"):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.name = name
        self.mat = None

    def update_mat(self, mat):
        mat = np.asarray(mat)
        self.mat = mat if self.mat is None else self.mat + mat

    def reset(self):
        self.mat = None

    @property
    def iou(self):
        h = self.mat.astype(np.float64)
        denom = h.sum(1) + h.sum(0) - np.diag(h)
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.diag(h) / denom

    @property
    def global_avg(self):
        return float(np.nanmean(self.iou)) if self.mat is not None \
            else float("nan")

    @property
    def avg(self):
        return self.global_avg

    def __str__(self):
        return "{iou:.4f}".format(iou=self.global_avg)

    @property
    def summary_str(self):
        return str(self)
