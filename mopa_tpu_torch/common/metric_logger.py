"""Windowed meters and a delimiter-joined metric logger (port of
``mopa_tpu/common/metric_logger.py``).

``AverageMeter`` keeps a sliding window (deque of 20) plus global totals;
``MetricLogger.update`` takes Python numbers, numpy arrays and 0-d tensors;
``iou_to_excel`` exports class-wise IoU tables as .xlsx workbooks through
the dependency-free writer of :mod:`mopa_tpu_torch.common.xlsx`, or as CSV
when a ``.csv`` path is given.
"""

from collections import defaultdict, deque

import numpy as np


class AverageMeter(object):
    """Track a series of values: windowed average + global average."""

    default_fmt = "{avg:.4f} ({global_avg:.4f})"

    def __init__(self, window_size=20, fmt=None):
        self.values = deque(maxlen=window_size)
        self.counts = deque(maxlen=window_size)
        self.sum = 0.0
        self.count = 0
        self.fmt = fmt or self.default_fmt

    def update(self, value, count=1):
        self.values.append(value)
        self.counts.append(count)
        self.sum += value
        self.count += count

    @property
    def avg(self):
        total = float(np.sum(self.counts)) if self.counts else 0.0
        return (float(np.sum(self.values)) / total) if total > 0 \
            else float("nan")

    @property
    def global_avg(self):
        return (self.sum / self.count) if self.count > 0 else float("nan")

    def reset(self):
        self.values.clear()
        self.counts.clear()
        self.sum = 0.0
        self.count = 0

    def __str__(self):
        return self.fmt.format(avg=self.avg, global_avg=self.global_avg)

    @property
    def summary_str(self):
        return "{global_avg:.4f}".format(global_avg=self.global_avg)


def _to_scalar(value):
    """A Python number from a number, a one-element numpy array or a 0-d
    tensor (a tensor on a card is copied to the host here); the mean of a
    larger array."""
    if hasattr(value, "item"):
        try:
            return value.item()
        except (ValueError, RuntimeError):
            return float(np.asarray(value).mean())
    return value


class MetricLogger(object):
    """Dict of named meters joined by a delimiter for log lines."""

    def __init__(self, delimiter="\t"):
        self.meters = defaultdict(AverageMeter)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            v = _to_scalar(v)
            if isinstance(v, (tuple, list)):
                value, count = v
                self.meters[k].update(_to_scalar(value), _to_scalar(count))
            else:
                self.meters[k].update(v)

    def add_meter(self, name_or_meter, meter=None):
        if meter is None:
            meter = name_or_meter
            name = meter.name
        else:
            name = name_or_meter
        self.meters[name] = meter

    def add_meters(self, meters):
        for m in meters:
            if m is not None:
                self.add_meter(m)

    def remove(self, name):
        self.meters.pop(name, None)

    def reset(self):
        for meter in self.meters.values():
            meter.reset()

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        return getattr(super(), attr)

    def __str__(self):
        return self.delimiter.join(
            "{}: {}".format(name, str(meter))
            for name, meter in self.meters.items())

    @property
    def summary_str(self):
        return self.delimiter.join(
            "{}: {}".format(name, meter.summary_str)
            for name, meter in self.meters.items())


def iou_to_excel(eval_dict, save_pth, modality_ls):
    """Write the class-wise IoU of each modality of ``eval_dict``
    (``Evaluator``s) as a one-sheet .xlsx workbook, or as CSV for a
    ``.csv`` path: a header row (modality, class names, ``overall_iou``),
    then one row per modality rounded to 4 places (a NaN IoU as 0)."""
    rows = []
    header = None
    for modality in modality_ls:
        evaluator = eval_dict[modality]
        if header is None:
            header = ["modality"] + list(evaluator.class_names) \
                + ["overall_iou"]
            rows.append(header)
        ious = [round(0.0 if np.isnan(v) else float(v), 4)
                for v in evaluator.class_iou]
        rows.append([modality] + ious
                    + [round(float(evaluator.overall_iou), 4)])
    if save_pth.endswith(".csv"):
        with open(save_pth, "w") as f:
            f.write("\n".join(",".join(str(c) for c in row)
                              for row in rows) + "\n")
        return save_pth
    from mopa_tpu_torch.common.xlsx import write_xlsx

    return write_xlsx(save_pth, rows, sheet_name="class_iou")
