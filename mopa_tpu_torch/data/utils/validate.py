"""The eval step and the validation / pseudo-label loop (PyTorch port of
``mopa_tpu/data/utils/validate.py``; reference
``mopa/data/utils/validate.py:26-229``).

:func:`make_eval_step` gives per-point 2D/3D probabilities on the card;
:func:`validate` slices each sample's predictions back to its original
(pre-voxelization) points, updates the 2D / 3D / softmax-ensemble (xM)
``Evaluator``s and optionally writes reference-format pseudo-label ``.npy``
files (probs_2d / pseudo_label_2d / probs_3d / pseudo_label_3d
[+ ori_keep_idx / ori_img_points for KITTI], validate.py:159-176). The
entropy-fusion branch (``entropy_fuse``) is the JAX package's working form
of the reference's (which crashes on an undefined name).
"""

from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np
import torch

from mopa_tpu_torch.common.spans import span
from mopa_tpu_torch.data.pspath_sort import pspath_sort
from mopa_tpu_torch.data.utils.evaluate import Evaluator
from mopa_tpu_torch.models import losses as L
from mopa_tpu_torch.models.build import plan_levels
from mopa_tpu_torch.train import trainer as trainer_mod
from mopa_tpu_torch.train.common import decode_batch, device_batch

# Names of the spans (profiler ranges) that mark the step's stages, in
# order. A ``torch.profiler`` trace of one request splits its time by these.
STAGES = ("eval/decode", "eval/net2d", "eval/plan", "eval/net3d",
          "eval/heads_losses")


def make_eval_step(cfg, models: trainer_mod.Models):
    """Return ``eval_step(batch) -> (probs_2d, probs_3d, seg_loss_2d,
    seg_loss_3d)`` running on the models' device.

    The step decodes the batch onto the device, runs the 2D net, builds the
    voxel plan (sorting the points itself, so any point order is right), runs
    the 3D net, and returns per-point softmax probabilities (B*P, C) and the
    masked CE losses against ``seg_label``. SalsaNext builds no plan: it
    reads the batch's range images (``proj_in``) and gathers its logits at
    each point's pixel (``proj_xy``). Each stage is one span
    (``common.spans``) named in :data:`STAGES`.
    """
    device = next(models.model_2d.parameters()).device
    is_range = plan_levels(cfg) is None  # a range net: no voxel plan

    @torch.no_grad()
    def eval_step(batch: dict):
        decode, net2d, plan_range, net3d, heads = STAGES
        models.model_2d.eval()  # a train step may share the models
        models.model_3d.eval()
        with span(decode):
            batch = decode_batch(batch, device)
            valid = batch["point_valid"].reshape(-1)
        with span(net2d):
            out2d = models.model_2d(batch["img"], batch["img_indices"],
                                    batch["point_valid"])
        if is_range:
            with span(net3d):
                out3d = models.model_3d(batch["feats"], None,
                                        proj_in=batch["proj_in"],
                                        proj_xy=batch["proj_xy"])
        else:
            with span(plan_range):
                plan = trainer_mod.build_plan_from_batch(
                    cfg, batch["coords"], valid,
                    sample_size=batch["point_valid"].shape[1])
            with span(net3d):
                out3d = models.model_3d(batch["feats"], plan)
        with span(heads):
            probs_2d = torch.softmax(out2d["seg_logit"], dim=-1)
            probs_3d = torch.softmax(out3d["seg_logit"], dim=-1)
            labeled = valid & (batch["seg_label"] >= 0)
            seg_loss_2d = L.cross_entropy(out2d["seg_logit"],
                                          batch["seg_label"], labeled)
            seg_loss_3d = L.cross_entropy(out3d["seg_logit"],
                                          batch["seg_label"], labeled)
        return probs_2d, probs_3d, seg_loss_2d, seg_loss_3d

    return eval_step


def _fused_entropy_pred(probs_2d: np.ndarray, probs_3d: np.ndarray):
    """Argmax of the entropy-weighted fusion: each modality weighted by
    exp(-sum of its ``prob_2_entropy``)."""
    e2 = np.exp(-L.prob_2_entropy(torch.from_numpy(probs_2d)).sum(-1)
                .numpy())
    e3 = np.exp(-L.prob_2_entropy(torch.from_numpy(probs_3d)).sum(-1)
                .numpy())
    w2 = (e2 / (e2 + e3))[..., None]
    return (w2 * probs_2d + (1 - w2) * probs_3d).argmax(-1)


def _knn_revote(points, point_valid, probs_3d, pred_3d, knn_kw):
    """(probs_3d, pred_3d) of a (B, P) batch re-voted scan by scan on the
    card by :func:`~mopa_tpu_torch.ops.knn.knn_postprocess_scan`: the
    labels, or with ``output_prob`` the neighbour-summed probabilities,
    renormalised."""
    from mopa_tpu_torch.ops.knn import knn_postprocess_scan

    device = points.device
    valid = torch.from_numpy(np.asarray(point_valid)).to(device)
    values = torch.from_numpy(probs_3d if knn_kw["output_prob"]
                              else pred_3d.astype(np.int32)).to(device)
    out = torch.stack([knn_postprocess_scan(points[i], valid[i], values[i],
                                            **knn_kw)
                       for i in range(points.shape[0])]).cpu().numpy()
    if not knn_kw["output_prob"]:
        return probs_3d, out
    probs_3d = out / np.maximum(out.sum(-1, keepdims=True), 1e-12)
    return probs_3d, probs_3d.argmax(-1)


def validate(cfg, models: trainer_mod.Models, dataloader, val_metric_logger,
             logger, pselab_dir=None, entropy_fuse=False) -> dict:
    """One pass of the eval step over ``dataloader`` (the models' current
    weights on their device; the train state's tensors are the models'
    own). Logs every ``VAL.LOG_PERIOD`` batches and the IoU tables at the
    end; puts ``seg_loss_2d/3d`` per batch and ``seg_iou_2d/3d/xM`` into
    ``val_metric_logger``; with ``pselab_dir`` writes one pseudo-label
    ``.npy`` per scan (:func:`~mopa_tpu_torch.data.pspath_sort.pspath_sort`).
    With ``VAL.use_knn`` the 3D predictions (with ``VAL.knn_prob`` its
    probabilities) are re-voted from each scan's range image first.
    Returns ``{"2D", "3D", "2D+3D"[, "xM_ety"]: Evaluator}``."""
    logger.info("Validation")
    class_names = dataloader.dataset.class_names
    evaluator_2d = Evaluator(class_names)
    evaluator_3d = Evaluator(class_names)
    evaluator_ensemble = Evaluator(class_names)
    evaluator_ety = Evaluator(class_names) if entropy_fuse else None
    for name in ("seg_iou_2d", "seg_iou_3d", "seg_iou_xM"):
        val_metric_logger.remove(name)

    eval_step = make_eval_step(cfg, models)
    device = next(models.model_2d.parameters()).device
    # range-image KNN post-processing of the 3D predictions (VAL.use_knn,
    # reference validate.py:46-50,98-109)
    use_knn = bool(cfg.VAL.use_knn)
    pc = cfg.TRAIN.PC_MM
    knn_kw = dict(nclasses=cfg.MODEL_3D.NUM_CLASSES, fov_up=pc.fov_up,
                  fov_down=pc.fov_down, proj_w=pc.proj_W, proj_h=pc.proj_H,
                  k=cfg.TRAIN.XMUDA.knn_k, output_prob=bool(cfg.VAL.knn_prob))
    is_kitti = "KITTI" in cfg.DATASET_TARGET.TYPE.upper()
    end = time.time()
    for iteration, batch in enumerate(dataloader):
        data_time = time.time() - end
        meta = batch.pop("_meta", {})
        dev_batch = device_batch(batch, device)
        probs_2d, probs_3d, loss_2d, loss_3d = eval_step(dev_batch)
        b, p = batch["img_indices"].shape[:2]
        # one copy to the host per batch
        probs = torch.stack([probs_2d, probs_3d]).float().cpu().numpy()
        losses = torch.stack([loss_2d, loss_3d]).float().cpu().numpy()
        probs_2d = probs[0].reshape(b, p, -1)
        probs_3d = probs[1].reshape(b, p, -1)
        pred_2d = probs_2d.argmax(-1)
        pred_3d = probs_3d.argmax(-1)
        if use_knn and "points_xyz" in dev_batch:
            probs_3d, pred_3d = _knn_revote(
                dev_batch["points_xyz"], batch["point_valid"], probs_3d,
                pred_3d, knn_kw)
        pred_xm = (probs_2d + probs_3d).argmax(-1)
        if entropy_fuse:
            pred_ety = _fused_entropy_pred(probs_2d, probs_3d)

        num_points = batch["num_points"]
        seg_labels = meta.get("orig_seg_label")
        points_idx = meta.get("orig_points_idx")
        for bi in range(b):
            n = int(num_points[bi])
            curr_pred_2d = pred_2d[bi, :n]
            curr_pred_3d = pred_3d[bi, :n]
            if seg_labels is not None:
                # every original point in the camera's view was voxelized
                curr_label = seg_labels[bi][points_idx[bi]][:n]
                evaluator_2d.update(curr_pred_2d, curr_label.copy())
                evaluator_3d.update(curr_pred_3d, curr_label.copy())
                evaluator_ensemble.update(pred_xm[bi, :n], curr_label.copy())
                if entropy_fuse:
                    evaluator_ety.update(pred_ety[bi, :n], curr_label.copy())
            if pselab_dir is not None:
                ps_path = pspath_sort(cfg, meta["lidar_path"][bi], pselab_dir)
                os.makedirs(osp.dirname(ps_path), exist_ok=True)
                data = {
                    "probs_2d": probs_2d[bi, np.arange(n), curr_pred_2d],
                    "pseudo_label_2d": curr_pred_2d.astype(np.uint8),
                    "probs_3d": probs_3d[bi, np.arange(n), curr_pred_3d],
                    "pseudo_label_3d": curr_pred_3d.astype(np.uint8),
                }
                if is_kitti:
                    data["ori_keep_idx"] = meta["ori_keep_idx"][bi]
                    data["ori_img_points"] = meta["ori_img_points"][bi]
                np.save(ps_path, data, allow_pickle=True)

        val_metric_logger.update(seg_loss_2d=losses[0], seg_loss_3d=losses[1],
                                 time=time.time() - end, data=data_time)
        end = time.time()
        cur_iter = iteration + 1
        if cur_iter == 1 or (cfg.VAL.LOG_PERIOD > 0
                             and cur_iter % cfg.VAL.LOG_PERIOD == 0):
            logger.info("iter: {}/{}  {}".format(
                cur_iter, len(dataloader), str(val_metric_logger)))

    val_metric_logger.update(seg_iou_2d=evaluator_2d.overall_iou,
                             seg_iou_3d=evaluator_3d.overall_iou,
                             seg_iou_xM=evaluator_ensemble.overall_iou)
    eval_list = [("2D", evaluator_2d), ("3D", evaluator_3d),
                 ("2D+3D", evaluator_ensemble)]
    if entropy_fuse:
        eval_list.append(("xM_ety", evaluator_ety))
    eval_dict = {}
    for modality, evaluator in eval_list:
        logger.info("{} overall accuracy={:.2f}%".format(
            modality, 100.0 * evaluator.overall_acc))
        logger.info("{} overall IOU={:.2f}".format(
            modality, 100.0 * evaluator.overall_iou))
        logger.info("{} class-wise segmentation accuracy and IoU.\n{}".format(
            modality, evaluator.print_table()))
        eval_dict[modality] = evaluator
    return eval_dict
