"""Evaluation-time confusion-matrix metrics (port of
``mopa_tpu/data/utils/evaluate.py``; reference
``mopa/data/utils/evaluate.py:4-84``).

Pure numpy, a copy of the JAX package's ``Evaluator``: -100 labels go to a
row outside the matrix, as the reference's ``num_classes`` trick does. The
JAX package prints its tables with ``tabulate`` (``psql`` and ``tsv``
formats); the port does not depend on it and writes the same strings
itself (:func:`_psql`, :func:`_tsv`).
"""

import numpy as np


def _afterpoint(s: str) -> int:
    """Digits after the decimal point of a formatted number, -1 without
    one (tabulate's rule for decimal alignment)."""
    try:
        float(s)
    except ValueError:
        return -1
    if "." not in s:
        return -1
    return len(s) - s.rfind(".") - 1


def _psql(headers, rows, floatfmt: str) -> str:
    """``tabulate(rows, headers, tablefmt="psql", floatfmt=floatfmt)`` for
    columns of str, int or float cells: strings left-aligned, numbers
    aligned on their decimal point, each column at least its header's
    width + 2, one space of padding."""
    columns = list(zip(*rows)) if rows else [()] * len(headers)
    cells, right = [], []
    for col in columns:
        if all(isinstance(v, (int, np.integer)) for v in col):
            text = [str(int(v)) for v in col]
        elif all(isinstance(v, (int, float, np.integer, np.floating))
                 for v in col):
            text = [format(float(v), floatfmt) for v in col]
        else:
            cells.append([str(v).strip() for v in col])
            right.append(False)
            continue
        decs = [_afterpoint(s) for s in text]
        top = max(decs, default=-1)
        cells.append([s + " " * (top - d) for s, d in zip(text, decs)])
        right.append(True)
    widths = [max([len(h) + 2] + [len(s) for s in col])
              for h, col in zip(headers, cells)]

    def line(fill, cross, ends):
        return ends[0] + cross.join(fill * (w + 2) for w in widths) + ends[1]

    def row(values):
        return "|" + "|".join(
            " " + (v.rjust(w) if r else v.ljust(w)) + " "
            for v, w, r in zip(values, widths, right)) + "|"

    out = [line("-", "+", "++"), row(headers), line("-", "+", "||")]
    out += [row(r) for r in zip(*cells)]
    out.append(line("-", "+", "++"))
    return "\n".join(out)


def _tsv(headers, rows, floatfmt: str) -> str:
    """``tabulate(rows, headers, tablefmt="tsv", floatfmt=floatfmt,
    numalign=None, stralign=None)`` for rows of floats."""
    lines = ["\t".join(headers)]
    lines += ["\t".join(format(float(v), floatfmt) for v in r) for r in rows]
    return "\n".join(lines)


class Evaluator(object):
    def __init__(self, class_names, labels=None):
        self.class_names = tuple(class_names)
        self.num_classes = len(class_names)
        self.labels = (np.arange(self.num_classes) if labels is None
                       else np.array(labels))
        assert self.labels.shape[0] == self.num_classes
        self.confusion_matrix = np.zeros((self.num_classes,
                                          self.num_classes))

    def update(self, pred_label, gt_label):
        pred = np.asarray(pred_label).flatten()
        gt = np.asarray(gt_label).flatten().copy()
        gt[gt == -100] = self.num_classes  # ignore bucket outside the matrix
        ok = (gt >= 0) & (gt < self.num_classes) & (pred >= 0) \
            & (pred < self.num_classes)
        inds = self.num_classes * gt[ok] + pred[ok]
        cm = np.bincount(inds.astype(np.int64),
                         minlength=self.num_classes ** 2)
        self.confusion_matrix += cm.reshape(self.num_classes,
                                            self.num_classes)

    def batch_update(self, pred_labels, gt_labels):
        assert len(pred_labels) == len(gt_labels)
        for pred_label, gt_label in zip(pred_labels, gt_labels):
            self.update(pred_label, gt_label)

    @property
    def overall_acc(self):
        total = np.sum(self.confusion_matrix)
        return np.sum(np.diag(self.confusion_matrix)) / max(total, 1e-12)

    @property
    def overall_iou(self):
        class_iou = np.array(self.class_iou, copy=True)
        class_iou[np.isnan(class_iou)] = 0
        return float(np.mean(class_iou))

    @property
    def class_seg_acc(self):
        return [self.confusion_matrix[i, i]
                / max(np.sum(self.confusion_matrix[i]), 1e-12)
                for i in range(self.num_classes)]

    @property
    def class_iou(self):
        iou_list = []
        for i in range(self.num_classes):
            tp = self.confusion_matrix[i, i]
            union = (self.confusion_matrix[:, i].sum()
                     + self.confusion_matrix[i, :].sum() - tp)
            iou_list.append(float("nan") if union == 0 else tp / union)
        return iou_list

    def print_table(self):
        header = ["Class", "Accuracy", "IOU", "Total"]
        table = [
            [name, acc * 100, iou * 100, int(self.confusion_matrix[i].sum())]
            for i, (name, acc, iou) in enumerate(
                zip(self.class_names, self.class_seg_acc, self.class_iou))
        ]
        return _psql(header, table, ".2f")

    def save_table(self, filename):
        header = ("overall acc", "overall iou") + self.class_names
        table = [[self.overall_acc, self.overall_iou] + self.class_iou]
        with open(filename, "w") as f:
            f.write(_tsv(header, table, ".5f"))
