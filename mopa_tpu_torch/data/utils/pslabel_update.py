"""Offline pseudo-label regeneration (PyTorch port of
``mopa_tpu/data/utils/pslabel_update.py``; reference
``mopa/data/utils/pslabel_update.py:27-189``).

A specialisation of the validation loop: with eval semantics (no
augmentation, original-point bookkeeping) over the target TRAIN split, it
writes one pseudo-label ``.npy`` per scan from the models' current weights
(on their device), with optional entropy-weighted 2D/3D fusion
(``entropy_fuse``)."""

from mopa_tpu_torch.common.metric_logger import MetricLogger
from mopa_tpu_torch.data.build import build_dataloader
from mopa_tpu_torch.data.utils.validate import validate


def pslabel_update(cfg, models, logger, pselab_dir, entropy_fuse=False):
    """Write the pseudo-labels of every target train scan under
    ``pselab_dir`` (paths by :func:`data.pspath_sort.pspath_sort`);
    returns :func:`validate`'s ``eval_dict``."""
    eval_cfg = cfg.clone()
    eval_cfg.DATASET_TARGET.TEST = tuple(cfg.DATASET_TARGET.TRAIN)
    eval_cfg.VAL.BATCH_SIZE = 1  # ps-label writing is per-scan
    loader = build_dataloader(eval_cfg, mode="test", domain="target")
    metric_logger = MetricLogger(delimiter="  ")
    return validate(eval_cfg, models, loader, metric_logger, logger,
                    pselab_dir=pselab_dir, entropy_fuse=entropy_fuse)
