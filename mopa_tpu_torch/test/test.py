#!/usr/bin/env python
"""Evaluation / pseudo-label generation CLI (port of
``mopa_tpu/test/test.py``; reference ``mopa/test/test.py``).

``python -m mopa_tpu_torch.test.test --cfg <yaml> --model_prefix <dir>
  [--ckpt2d x.pth --ckpt3d y.pth] [--pselab_dir NAME] [KEY VALUE ...]``
on a CUDA device (``cuda:LOCAL_RANK``). Under ``torchrun`` rank 0 alone
evaluates the whole split and writes the pseudo-labels; the other ranks
exit.
"""

import os.path as osp

import torch
import torch.distributed as dist

from mopa_tpu_torch.common.checkpoint import CheckpointerV2
from mopa_tpu_torch.common.logger import get_logger
from mopa_tpu_torch.common.metric_logger import MetricLogger
from mopa_tpu_torch.common.rng import set_random_seed
from mopa_tpu_torch.data.build import build_dataloader
from mopa_tpu_torch.data.utils.validate import validate
from mopa_tpu_torch.parallel import mesh as mesh_mod
from mopa_tpu_torch.train import trainer as trainer_mod
from mopa_tpu_torch.train.common import load_cfg, parse_args, require_cuda


def test_model(cfg, logger, args, device="cuda"):
    """Validate the two checkpoint streams in ``args.model_prefix`` (the
    pointer files' latest, or ``args.ckpt2d`` / ``args.ckpt3d``; weights
    only) on the target's test split, on ``device``; with
    ``args.pselab_dir`` write the pseudo-labels. Returns the
    ``eval_dict``."""
    set_random_seed(cfg.RNG_SEED)
    models = trainer_mod.build_models(cfg, device=device)
    state = trainer_mod.create_train_state(cfg, models)
    loader = build_dataloader(cfg, mode="test", domain="target")
    for which, postfix, ckpt in (("2d", "_2d", args.ckpt2d),
                                 ("3d", "_3d", args.ckpt3d)):
        ck = CheckpointerV2(trainer_mod.CheckpointAdapter(which, models,
                                                          state),
                            save_dir=args.model_prefix, logger=logger,
                            postfix=postfix)
        path = osp.join(args.model_prefix, ckpt) if ckpt else None
        ck.load(path, resume=not ckpt, resume_states=False)

    pselab_dir = args.pselab_dir
    if pselab_dir is not None:
        assert len(cfg.DATASET_TARGET.TEST) == 1
    metric_logger = MetricLogger(delimiter="  ")
    return validate(cfg, models, loader, metric_logger, logger,
                    pselab_dir=pselab_dir)


def main():
    args = parse_args("MoPA evaluation (GPU)",
                      "configs/nuscenes/usa_singapore/xmuda.yaml",
                      with_test_args=True)
    require_cuda()
    mesh_mod.initialize_distributed()
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    cfg = load_cfg(args)
    logger = get_logger(abbrev_name=args.task)
    logger.info("{} devices available".format(torch.cuda.device_count()))
    logger.info(args)
    test_model(cfg, logger, args, device=mesh_mod.local_device())


if __name__ == "__main__":
    main()
