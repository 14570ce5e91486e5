"""The eval step (PyTorch port of
``mopa_tpu/data/utils/validate.py::make_eval_step``, SCN branch)."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from mopa_tpu_torch.models import losses as L
from mopa_tpu_torch.train import trainer as trainer_mod
from mopa_tpu_torch.train.common import decode_batch

# Names of the profiler ranges that mark the step's stages, in order. A
# ``torch.profiler`` trace of one request splits its time by these.
STAGES = ("eval/decode", "eval/net2d", "eval/plan", "eval/net3d",
          "eval/heads_losses")


def make_eval_step(cfg, models: trainer_mod.Models):
    """Return ``eval_step(batch) -> (probs_2d, probs_3d, seg_loss_2d,
    seg_loss_3d)`` running on the models' device.

    The step decodes the batch onto the device, runs the 2D net, builds the
    voxel plan (sorting the points itself, so any point order is right), runs
    the 3D net, and returns per-point softmax probabilities (B*P, C) and the
    masked CE losses against ``seg_label``. Each stage is one
    ``record_function`` range named in :data:`STAGES`.
    """
    device = next(models.model_2d.parameters()).device

    @torch.no_grad()
    def eval_step(batch: dict):
        decode, net2d, plan_range, net3d, heads = STAGES
        models.model_2d.eval()  # a train step may share the models
        models.model_3d.eval()
        with record_function(decode):
            batch = decode_batch(batch, device)
            valid = batch["point_valid"].reshape(-1)
        with record_function(net2d):
            out2d = models.model_2d(batch["img"], batch["img_indices"],
                                    batch["point_valid"])
        with record_function(plan_range):
            plan = trainer_mod.build_plan_from_batch(
                cfg, batch["coords"], valid,
                sample_size=batch["point_valid"].shape[1])
        with record_function(net3d):
            out3d = models.model_3d(batch["feats"], plan)
        with record_function(heads):
            probs_2d = torch.softmax(out2d["seg_logit"], dim=-1)
            probs_3d = torch.softmax(out3d["seg_logit"], dim=-1)
            labeled = valid & (batch["seg_label"] >= 0)
            seg_loss_2d = L.cross_entropy(out2d["seg_logit"],
                                          batch["seg_label"], labeled)
            seg_loss_3d = L.cross_entropy(out3d["seg_logit"],
                                          batch["seg_label"], labeled)
        return probs_2d, probs_3d, seg_loss_2d, seg_loss_3d

    return eval_step
