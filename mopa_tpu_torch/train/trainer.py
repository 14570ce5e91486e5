"""Models, voxel plans and the MoPA train step (PyTorch port of
``mopa_tpu/train/trainer.py``).

The student step is the one every iteration of a MoPA run takes: one fused
forward per modality over the stacked [source; target] batches (per-domain
batch norm), the source CE, cross-modal KL, pseudo-label CE, MinEnt and SAM
consistency losses, one joint backward (the cross-modal teachers are
detached exactly where the reference calls ``.detach()``), an update of each
net by its own optimizer, then the EMA update. From ``ema_start_iter`` on
(``with_ema``), an EMA teacher first labels the target batch from its
unaugmented view, and its labels replace the offline pseudo labels.

With ``TRAIN.PC_MM.lambda_pc_mm`` > 0 (the shipped MoPA config) the step
also trains the 3D net on the VGI cat domain, the target scans with objects
inserted: a third batch-norm domain of the fused 3D forward, with its own
CE loss. The cat domain comes from host VGI (``data.vgi_host``) where the
target batch carries its ``hp_cat_*`` plan, else from device VGI
(``ops.mixmatch``, stage ``train/vgi``) over the batch's raw VGI inputs,
with its plan built on the card. Voxel plans come from the batch's
host-built ``hp_*`` / ``hp_ori_*`` / ``hp_cat_*`` keys where it has them,
else from the device build.

The 3D net is ``MODEL_3D.TYPE``'s: SCN, SPVCNN (a 5-level plan, 4-channel
point features) or SalsaNext (range images, no plan: its source and target
forwards run back to back, one batch norm updating its running statistics
in turn). With ``TRAIN.DEPTH_PRED`` the 2D net's depth head is trained by
the RMSE against the source's ``depth_label`` (weight
``TRAIN.DEPTH_PRED_COE.lambda_dp_src``). The combinations the JAX package
cannot run either raise as noted in :func:`make_train_step`.

Data parallelism (``mesh``, a ``parallel.mesh.DataMesh``) follows the JAX
package's ``shard_map``-ed step: every rank holds the whole train state and
steps on its own block of the batch; after the backward the gradients and
the updated batch-norm running statistics of each net are averaged across
the ranks, one flat bucket per net and kind, the float metrics averaged and
the integer ones (the confusion matrices, ``vgi_inserted``) summed, before
the optimizers run. Batch norm normalises with each rank's own statistics,
and the EMA teacher runs per rank with no collective. Every rank's
generator starts from the same seed and draws the same shapes, so dropout,
the teacher's fusion draw and device VGI's draws agree across ranks, as
JAX's replicated key makes them.

With ``MODEL_2D.<TYPE>.pretrained`` (the default) :func:`create_train_state`
loads the ImageNet ResNet34 encoder from the file
:func:`resolve_resnet34_weights` names, as the JAX package does.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mopa_tpu_torch.common.solver import (OptimizerSpec, ScheduledOptimizer,
                                          build_optimizer)
from mopa_tpu_torch.common.spans import span
from mopa_tpu_torch.data.utils.refine_pseudo_labels import \
    refine_pseudo_labels
from mopa_tpu_torch.models import losses as L
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.models.build import (build_model_2d, build_model_3d,
                                         plan_levels)
from mopa_tpu_torch.models.metric import confusion_matrix
from mopa_tpu_torch.models.scn_unet import (HOST_PLAN_KEYS, UNetPlan,
                                            build_unet_plan,
                                            build_unet_plan_batched,
                                            capacity_schedule, concat_plans,
                                            plan_from_host_arrays)
from mopa_tpu_torch.ops import mixmatch
from mopa_tpu_torch.parallel import mesh as mesh_mod
from mopa_tpu_torch.train.common import decode_batch, is_ema_key

# Names of the spans (profiler ranges) that mark the train step's stages, in
# order.
TRAIN_STAGES = ("train/decode", "train/vgi", "train/plan", "train/net2d",
                "train/net3d", "train/losses", "train/backward",
                "train/allreduce", "train/optim", "train/ema")
# The EMA teacher's stages, which run before the train step's in the EMA
# phase.
TEACHER_STAGES = ("teacher/decode", "teacher/plan", "teacher/net2d",
                  "teacher/net3d", "teacher/refine")
# The span around a whole step (teacher and student), of id ``state.step``.
STEP_SPAN = "train/step"


def _num_levels(cfg) -> int:
    levels = plan_levels(cfg)
    if levels is None:
        raise ValueError("{} runs on range images and builds no voxel plan"
                         .format(cfg.MODEL_3D.TYPE))
    return levels


def _host_plan(batch: dict, prefix: str, capacities, num_levels: int,
               sample_domains=None) -> UNetPlan:
    """The plan of a decoded batch's host-built ``<prefix>*`` keys."""
    return plan_from_host_arrays({k: batch[prefix + k]
                                  for k in HOST_PLAN_KEYS}, capacities,
                                 num_levels, sample_domains=sample_domains)


def _capacities(cfg, n_points: int):
    """Per-level capacities; ``TPU.CAP_FACTORS`` overrides the built-in
    LiDAR-measured schedule."""
    factors = tuple(cfg.TPU.get("CAP_FACTORS", ())) if "TPU" in cfg else ()
    return capacity_schedule(n_points, _num_levels(cfg),
                             factors=factors or None)


def build_plan_from_batch(cfg, coords: torch.Tensor, valid_flat: torch.Tensor,
                          sample_size: int | None,
                          sample_domains=None,
                          batch_idx: torch.Tensor | None = None) -> UNetPlan:
    """Voxel plan for a flat (S*P, 3) batch of S scans of P points each,
    built per sample and stitched into the reference's flat layout. The
    points are sorted here whatever their order. ``sample_domains`` (S,)
    gives each scan's batch-norm domain for a fused forward.

    With ``sample_size`` None the reference's monolithic plan of all the
    points (:func:`build_unet_plan`, ``nbr`` levels) over ``batch_idx``
    (each point's scan), capacities scheduled from the point count."""
    if sample_size is None:
        if batch_idx is None:
            raise ValueError("the monolithic plan needs batch_idx")
        return build_unet_plan(coords, batch_idx, valid_flat,
                               _num_levels(cfg),
                               capacities=_capacities(cfg, coords.shape[0]),
                               batch_domains=sample_domains)
    p = int(sample_size)
    s = coords.shape[0] // p
    return build_unet_plan_batched(coords.reshape(s, p, 3),
                                   valid_flat.reshape(s, p), _num_levels(cfg),
                                   capacities=_capacities(cfg, p),
                                   sample_domains=sample_domains)


def device_vgi(cfg, batch_trg: dict, scan_labels: bool,
               generator: torch.Generator) -> tuple:
    """VGI on the card over a decoded target batch's raw VGI inputs
    (:func:`ops.mixmatch.vgi_insert`, its draws from ``generator``; the
    scans' pseudo labels with ``scan_labels``): (cat, plan of the B cat
    scans of P + K*O points in BN domain 2, built on the card)."""
    with torch.no_grad():
        cat = mixmatch.vgi_insert(cfg, batch_trg, scan_labels, generator)
        b = cat["inserted"].shape[0]
        plan = build_plan_from_batch(cfg, cat["coords"], cat["valid"],
                                     cat["valid"].shape[0] // b,
                                     sample_domains=[2] * b)
    return cat, plan


def build_train_plan(cfg, batch_src: dict, batch_trg: dict,
                     with_vgi: bool, device_cat: tuple | None = None
                     ) -> tuple:
    """(plan, cat) of the student step over decoded batches: one fused plan
    of the 2B [source; target] scans (BN domains 0 and 1), decoded from their
    ``hp_*`` keys where both batches have them, else built from their
    coordinates; with ``with_vgi`` the B cat scans (domain 2) concatenated
    after them: ``device_cat`` (:func:`device_vgi`'s (cat, plan)) where
    given, else host VGI's (``hp_cat_*``). ``cat`` holds their flat
    ``valid``, ``label``, ``obj_mask`` and all-ones ``feats`` (else
    None)."""
    b, p = batch_src["img_indices"].shape[:2]
    num_levels = _num_levels(cfg)
    doms = [0] * b + [1] * b
    with torch.no_grad():
        if "hp_rankn" in batch_src and "hp_rankn" in batch_trg:
            with span("plan/decode", trace=False):
                plan = plan_from_host_arrays(
                    {k: torch.cat([batch_src["hp_" + k],
                                   batch_trg["hp_" + k]])
                     for k in HOST_PLAN_KEYS}, _capacities(cfg, p),
                    num_levels, sample_domains=doms)
        else:
            with span("plan/build", trace=False):
                plan = build_unet_plan_batched(
                    torch.cat([batch_src["coords"],
                               batch_trg["coords"]]).reshape(2 * b, p, 3),
                    torch.cat([batch_src["point_valid"],
                               batch_trg["point_valid"]]),
                    num_levels, capacities=_capacities(cfg, p),
                    sample_domains=doms)
        if not with_vgi:
            return plan, None
        if device_cat is not None:
            cat, cat_plan = device_cat
        else:
            valid = batch_trg["cat_valid"].reshape(-1)
            cat = {"valid": valid,
                   "label": batch_trg["cat_label"].reshape(-1),
                   "obj_mask": batch_trg["cat_obj_mask"].reshape(-1),
                   "feats": torch.ones((valid.shape[0], 1),
                                       device=valid.device)}
            with span("plan/decode", trace=False):
                cat_plan = _host_plan(batch_trg, "hp_cat_",
                                      _capacities(cfg, valid.shape[0] // b),
                                      num_levels, sample_domains=[2] * b)
        with span("plan/concat", trace=False):
            return concat_plans([plan, cat_plan]), cat


class Models(NamedTuple):
    model_2d: nn.Module
    model_3d: nn.Module
    tx_2d: OptimizerSpec | None = None
    tx_3d: OptimizerSpec | None = None


def resolve_resnet34_weights(cfg) -> str:
    """The pretrained ResNet34 weights file a run would load, or "": the
    path in ``TPU.RESNET34_WEIGHTS``, else in ``$MOPA_RESNET34_WEIGHTS``,
    when a file is there. A torchvision ``.pth`` state dict, or the ``.npz``
    of the JAX package's ``tools/convert_resnet34.py`` (flax names)."""
    path = ""
    if "TPU" in cfg and cfg.TPU.get("RESNET34_WEIGHTS", ""):
        path = cfg.TPU.RESNET34_WEIGHTS
    path = path or os.environ.get("MOPA_RESNET34_WEIGHTS", "")
    return path if path and os.path.isfile(path) else ""


def build_models(cfg, device="cuda", seed: int | None = None) -> Models:
    """Both nets with seeded random weights (``RNG_SEED`` unless ``seed``),
    on ``device`` (the GPU unless the caller asks for the CPU), and, where
    the config names them, their optimizers."""
    gen = torch.Generator().manual_seed(
        int(cfg.RNG_SEED if seed is None else seed))
    model_2d = build_model_2d(cfg, generator=gen)
    model_3d = build_model_3d(cfg, generator=gen)
    optim = cfg.OPTIMIZER
    tx_2d = tx_3d = None
    if optim.MODEL_2D.TYPE or optim.TYPE:
        tx_2d = build_optimizer(optim.MODEL_2D, cfg)
    if optim.MODEL_3D.TYPE or optim.TYPE:
        tx_3d = build_optimizer(optim.MODEL_3D, cfg)
    return Models(model_2d.to(device), model_3d.to(device), tx_2d, tx_3d)


@dataclass
class TrainState:
    """What a train step reads and updates. The parameter and buffer dicts
    hold the nets' own tensors (float32 parameters; batch-norm running
    statistics), so the step updates them in place; the EMA dicts hold
    float32 copies; ``rng`` draws the dropout masks."""

    params_2d: dict
    batch_stats_2d: dict
    opt_2d: ScheduledOptimizer
    params_3d: dict
    batch_stats_3d: dict
    opt_3d: ScheduledOptimizer
    ema_params_2d: dict
    ema_params_3d: dict
    step: int
    rng: torch.Generator


def create_train_state(cfg, models: Models, seed: int | None = None,
                       flax_variables=None) -> TrainState:
    """The train state over ``models``: their seeded weights, or, with
    ``flax_variables`` = (params_2d, batch_stats_2d, params_3d,
    batch_stats_3d) as flattened flax dicts, the reference's weights through
    the bridge. With ``MODEL_2D.<TYPE>.pretrained`` the 2D encoder is then
    loaded from :func:`resolve_resnet34_weights`'s file (the decoder keeps
    its weights), or a warning says that it trains from scratch.
    Optimizers start empty, the EMA params equal the params, ``step`` is 0
    and ``rng`` is seeded from ``seed`` (``RNG_SEED``)."""
    if flax_variables is not None:
        weights.load_flax_params(models.model_2d, models.model_3d,
                                 *flax_variables)
    if cfg.MODEL_2D.get(cfg.MODEL_2D.TYPE, {}).get("pretrained", True):
        path = resolve_resnet34_weights(cfg)
        if path:
            weights.load_resnet34_file(models.model_2d, path)
        else:
            logging.getLogger("mopa_tpu_torch").warning(
                "MODEL_2D pretrained=True but no resnet34 weights file found "
                "(set TPU.RESNET34_WEIGHTS or MOPA_RESNET34_WEIGHTS); "
                "the 2D encoder trains from scratch.")
    if models.tx_2d is None or models.tx_3d is None:
        raise ValueError("OPTIMIZER.MODEL_2D/3D.TYPE must name an optimizer")
    device = next(models.model_2d.parameters()).device
    seed = int(cfg.RNG_SEED if seed is None else seed)
    p2d = dict(models.model_2d.named_parameters())
    p3d = dict(models.model_3d.named_parameters())
    return TrainState(
        params_2d=p2d, batch_stats_2d=dict(models.model_2d.named_buffers()),
        opt_2d=models.tx_2d.init(list(p2d.values())),
        params_3d=p3d, batch_stats_3d=dict(models.model_3d.named_buffers()),
        opt_3d=models.tx_3d.init(list(p3d.values())),
        ema_params_2d={k: v.detach().clone() for k, v in p2d.items()},
        ema_params_3d={k: v.detach().clone() for k, v in p3d.items()},
        step=0,
        rng=torch.Generator(device=device).manual_seed(seed))


def teacher_forward(cfg, models: Models, state: TrainState, batch: dict):
    """The EMA teacher's float32 softmax (B*P, C) of the 2D and of the 3D net
    over a decoded batch's unaugmented view (``ori_*`` keys).

    Both nets run in eval mode without gradients, with the EMA parameters
    and the student's batch-norm running statistics, as the reference's
    teacher applies ``ema_params`` with ``batch_stats``. The plan, in one
    batch-norm domain, is decoded from the batch's ``hp_ori_*`` keys, or,
    without them, built from ``ori_coords``."""
    _, plan_r, net2d, net3d, _ = TEACHER_STAGES
    p = batch["ori_img_indices"].shape[1]
    valid = batch["ori_point_valid"]
    models.model_2d.eval()
    models.model_3d.eval()
    with torch.no_grad():
        with span(plan_r):
            if "hp_ori_rankn" in batch:
                plan = _host_plan(batch, "hp_ori_", _capacities(cfg, p),
                                  _num_levels(cfg))
            else:
                plan = build_plan_from_batch(cfg, batch["ori_coords"],
                                             valid.reshape(-1), p)
        with span(net2d):
            out2d = functional_call(models.model_2d, state.ema_params_2d,
                                    (batch["ori_img"],
                                     batch["ori_img_indices"], valid))
        with span(net3d):
            out3d = functional_call(models.model_3d, state.ema_params_3d,
                                    (batch["ori_feats"], plan))
        return (torch.softmax(out2d["seg_logit"].float(), dim=-1),
                torch.softmax(out3d["seg_logit"].float(), dim=-1))


def teacher_labels(probs_2d: torch.Tensor, probs_3d: torch.Tensor,
                   valid: torch.Tensor, ema_map: torch.Tensor, use_xm: bool,
                   num_classes: int):
    """The teacher's labels (B*P_student,) int64 for the 2D and the 3D loss.

    ``use_xm``: one refinement of the entropy-weighted fusion of both nets'
    probabilities (per class: each modality weighted by the inverse of its
    ``prob_2_entropy``), used for both; else each net's own probabilities
    refined. ``valid`` (B*P,) masks the ori points; ``ema_map`` (B,
    P_student) gives each student point's position in its scan's ori view;
    entries outside [0, P) give -100."""
    def refine(probs):
        return refine_pseudo_labels(probs.amax(dim=-1), probs.argmax(dim=-1),
                                    valid, num_classes)

    if use_xm:
        rv2 = 1.0 / (L.prob_2_entropy(probs_2d) + 1e-30)
        rv3 = 1.0 / (L.prob_2_entropy(probs_3d) + 1e-30)
        w2 = rv2 / (rv2 + rv3)
        ps_2d = ps_3d = refine(w2 * probs_2d + (1.0 - w2) * probs_3d)
    else:
        ps_2d, ps_3d = refine(probs_2d), refine(probs_3d)
    b = ema_map.shape[0]
    p = valid.shape[0] // b
    base = torch.arange(b, device=ema_map.device)[:, None] * p
    seen = (ema_map >= 0) & (ema_map < p)
    flat = torch.where(seen, ema_map + base,
                       torch.full_like(ema_map, -1)).reshape(-1)
    safe = flat.clamp(0, b * p - 1)
    ignore = torch.full_like(flat, -100)
    return (torch.where(flat >= 0, ps_2d[safe], ignore),
            torch.where(flat >= 0, ps_3d[safe], ignore))


def make_train_step(cfg, models: Models, *, with_pl: bool,
                    with_ema: bool = False, with_mopa: bool = True,
                    mesh=None):
    """Return ``train_step(state, batch_src, batch_trg) -> (state,
    metrics)`` on the models' device; with ``mesh`` (a
    ``parallel.mesh.DataMesh``) this rank's step over its block of the
    batch, its gradients, batch-norm statistics and metrics reduced across
    the mesh (module docstring).

    ``with_pl``: pseudo-label CE on the target (``pseudo_label_2d/3d``);
    ``with_ema`` (needs ``with_pl``): the EMA phase, where a teacher labels
    the target first (:func:`teacher_forward`, :func:`teacher_labels`) from
    the target's EMA-only keys (``train.common.EMA_ONLY_KEYS``), its labels
    replace ``pseudo_label_2d/3d``, and the EMA-only keys are stripped before
    the student step; ``with_mopa``: the MoPA-only SAM consistency
    (``sam_mask``) and VGI terms. The cross-modal, MinEnt, SAM and VGI terms
    are on where their lambdas are > 0; VGI reads the target's host VGI keys
    (``cat_valid``, ``cat_label``, ``cat_obj_mask``, ``hp_cat_*``) where it
    has ``hp_cat_rankn``, else runs :func:`device_vgi` over its raw VGI
    inputs with draws from ``state.rng``. The step updates ``state`` in
    place and returns it with ``step`` + 1;
    ``metrics`` maps names to device tensors (losses, ``total_loss``, the
    int64 confusion matrices ``cm_src_2d``/``cm_src_3d``, and with VGI
    ``pc_mm_acc`` and ``vgi_inserted``, with ``TRAIN.DEPTH_PRED``
    ``depth_pred_loss``). The step is one :data:`STEP_SPAN` span
    (``common.spans``) of id ``state.step``, and each stage one span
    named in :data:`TRAIN_STAGES` (and :data:`TEACHER_STAGES`). With
    ``with_ema`` the returned step exposes its halves as ``.teacher_step(state,
    batch_trg) -> (pl_2d, pl_3d)`` (int16) and ``.student_step``.

    Raises, where the JAX package cannot run the combination either:
    SalsaNext with VGI or the EMA teacher (``ValueError``; JAX asserts), and
    SPVCNN with either (``NotImplementedError`` naming ROADMAP Queue 3: the
    cat scans and the teacher's view carry one feature channel)."""
    lam = cfg.TRAIN.XMUDA
    pc_mm = cfg.TRAIN.PC_MM
    if with_ema and not with_pl:
        raise ValueError("EMA teacher implies pseudo-label CE (with_pl)")
    with_vgi = with_mopa and float(pc_mm.lambda_pc_mm) > 0
    is_range = plan_levels(cfg) is None  # a range net: no voxel plan
    if is_range and (with_vgi or with_ema):
        raise ValueError("VGI and the EMA teacher are paths of the voxel "
                         "backbones; the JAX package asserts the same for "
                         "{}".format(cfg.MODEL_3D.TYPE))
    if "SPVCNN" in cfg.MODEL_3D.TYPE and (with_vgi or with_ema):
        raise NotImplementedError(
            "{} with {}: the VGI cat scans and the teacher's view carry one "
            "all-ones feature channel against SPVCNN's {}; the JAX package "
            "fails there too (ROADMAP Queue 3)".format(
                cfg.MODEL_3D.TYPE, "VGI" if with_vgi else "the EMA teacher",
                cfg.MODEL_3D.SPVCNN.in_channels))
    with_depth = bool(cfg.TRAIN.get("DEPTH_PRED", False))
    lambda_dp_src = float(cfg.TRAIN.DEPTH_PRED_COE.lambda_dp_src)
    dual_head = bool(cfg.MODEL_2D.DUAL_HEAD)
    num_classes = int(cfg.MODEL_2D.NUM_CLASSES)
    with_xm_src = lam.lambda_xm_src > 0
    with_xm_trg = lam.lambda_xm_trg > 0
    with_minent = lam.lambda_minent > 0
    with_sam = with_mopa and pc_mm.lambda_sam_cons > 0
    mask_budget = int(cfg.TPU.SAM_MASK_BUDGET)
    ema_alpha = float(pc_mm.ema_alpha_teacher)
    ema_period = max(int(pc_mm.ema_update_period), 1)
    ema_start = int(pc_mm.ema_start_iter)
    device = next(models.model_2d.parameters()).device
    class_weights = (torch.tensor(cfg.TRAIN.CLASS_WEIGHTS,
                                  dtype=torch.float32, device=device)
                     if cfg.TRAIN.CLASS_WEIGHTS else None)
    pl_weights = class_weights if pc_mm.use_class_weights else None
    model_2d, model_3d = models.model_2d, models.model_3d
    if with_sam and not model_2d.output_all:
        raise ValueError("the SAM loss needs the 2D net's seg_logit_all: "
                         "build the models with TRAIN.PC_MM.lambda_sam_cons "
                         "> 0")

    def losses(out2d, out3d, batch_src, batch_trg, cat, b, p):
        metrics = {}
        npnt = b * p
        per_point = ("feats", "seg_logit", "seg_logit2")
        src_2d = {k: out2d[k][:npnt] for k in per_point if k in out2d}
        trg_2d = {k: out2d[k][npnt:] for k in per_point if k in out2d}
        src_3d = {k: v[:npnt] for k, v in out3d.items()}
        trg_3d = {k: v[npnt:2 * npnt] for k, v in out3d.items()}

        src_valid = batch_src["point_valid"].reshape(-1)
        seg_label = batch_src["seg_label"]
        labelled = src_valid & (seg_label >= 0)
        with span("loss/ce", trace=False):
            loss_src_2d = L.cross_entropy(src_2d["seg_logit"], seg_label,
                                          labelled, class_weights)
            loss_src_3d = L.cross_entropy(src_3d["seg_logit"], seg_label,
                                          labelled, class_weights)
        metrics["loss_src_2d"] = loss_src_2d
        metrics["loss_src_3d"] = loss_src_3d
        total = loss_src_2d + loss_src_3d

        if with_xm_src:
            s2 = src_2d["seg_logit2" if dual_head else "seg_logit"]
            s3 = src_3d["seg_logit2" if dual_head else "seg_logit"]
            with span("loss/xm", trace=False):
                xm_2d = L.xm_kl_div(s2, src_3d["seg_logit"].detach(),
                                    src_valid)
                xm_3d = L.xm_kl_div(s3, src_2d["seg_logit"].detach(),
                                    src_valid)
            metrics["xm_loss_src_2d"] = xm_2d
            metrics["xm_loss_src_3d"] = xm_3d
            total = total + lam.lambda_xm_src * (xm_2d + xm_3d)

        if with_depth:
            diff = out2d["depth_pred"][:b].float() - batch_src["depth_label"]
            depth_loss = diff.square().mean().sqrt()
            metrics["depth_pred_loss"] = depth_loss
            total = total + lambda_dp_src * depth_loss

        with span("loss/cm", trace=False), torch.no_grad():
            metrics["cm_src_2d"] = confusion_matrix(
                src_2d["seg_logit"], seg_label, src_valid, num_classes)
            metrics["cm_src_3d"] = confusion_matrix(
                src_3d["seg_logit"], seg_label, src_valid, num_classes)

        trg_valid = batch_trg["point_valid"].reshape(-1)
        if with_xm_trg:
            t2 = trg_2d["seg_logit2" if dual_head else "seg_logit"]
            t3 = trg_3d["seg_logit2" if dual_head else "seg_logit"]
            with span("loss/xm", trace=False):
                xm_2d = L.xm_kl_div(t2, trg_3d["seg_logit"].detach(),
                                    trg_valid)
                xm_3d = L.xm_kl_div(t3, trg_2d["seg_logit"].detach(),
                                    trg_valid)
            metrics["xm_loss_trg_2d"] = xm_2d
            metrics["xm_loss_trg_3d"] = xm_3d
            total = total + lam.lambda_xm_trg * (xm_2d + xm_3d)

        if with_pl:
            pl_2d = batch_trg["pseudo_label_2d"].reshape(-1)
            pl_3d = batch_trg["pseudo_label_3d"].reshape(-1)
            with span("loss/pl", trace=False):
                pl_loss_2d = L.cross_entropy(trg_2d["seg_logit"], pl_2d,
                                             trg_valid & (pl_2d >= 0),
                                             pl_weights)
                pl_loss_3d = L.cross_entropy(trg_3d["seg_logit"], pl_3d,
                                             trg_valid & (pl_3d >= 0),
                                             pl_weights)
            metrics["pl_loss_trg_2d"] = pl_loss_2d
            metrics["pl_loss_trg_3d"] = pl_loss_3d
            total = total + lam.lambda_pl * (pl_loss_2d + pl_loss_3d)

        if with_minent:
            with span("loss/minent", trace=False):
                me = L.entropy_loss(torch.softmax(trg_2d["seg_logit"],
                                                  dim=-1), trg_valid)
                me3 = L.entropy_loss(torch.softmax(trg_3d["seg_logit"],
                                                   dim=-1), trg_valid)
            metrics["minent_2d"] = me
            metrics["minent_3d"] = me3
            total = total + lam.lambda_minent * (me + me3)

        if with_sam:
            with span("loss/sam", trace=False):
                probs_all = torch.softmax(out2d["seg_logit_all"][b:], dim=-1)
                sam = L.mask_cons_loss(probs_all, batch_trg["sam_mask"],
                                       mask_budget, min_entropy=True)
            metrics["sam_cons_loss"] = sam
            total = total + pc_mm.lambda_sam_cons * sam

        if cat is not None:
            cat_logit = out3d["seg_logit"][2 * npnt:]
            with span("loss/vgi", trace=False):
                vgi_loss = L.cross_entropy(cat_logit, cat["label"],
                                           cat["valid"] & (cat["label"] >= 0),
                                           pl_weights)
                with torch.no_grad():
                    obj = cat["obj_mask"] & cat["valid"]
                    hit = (cat_logit.argmax(dim=-1) == cat["label"]) & obj
                    metrics["pc_mm_acc"] = hit.sum() / obj.sum().clamp(min=1)
                    metrics["vgi_inserted"] = obj.sum()
            metrics["pc_mm_loss"] = vgi_loss
            total = total + pc_mm.lambda_pc_mm * vgi_loss
        metrics["total_loss"] = total
        return total, metrics

    def train_step(state: TrainState, batch_src: dict, batch_trg: dict):
        (decode, vgi_r, plan_r, net2d, net3d, loss_r, backward, allreduce,
         optim, ema) = TRAIN_STAGES
        model_2d.train()
        model_3d.train()
        with span(decode):
            batch_src = decode_batch(batch_src, device)
            batch_trg = decode_batch(batch_trg, device)
            b, p = batch_src["img_indices"].shape[:2]
        device_cat = None
        if with_vgi and "hp_cat_rankn" not in batch_trg:
            with span(vgi_r):
                device_cat = device_vgi(cfg, batch_trg, with_pl, state.rng)
        plan = cat = None
        if not is_range:
            with span(plan_r):
                plan, cat = build_train_plan(cfg, batch_src, batch_trg,
                                             with_vgi, device_cat)
        state.opt_2d.zero_grad()
        state.opt_3d.zero_grad()
        with span(net2d):
            out2d = model_2d(
                torch.cat([batch_src["img"], batch_trg["img"]]),
                torch.cat([batch_src["img_indices"],
                           batch_trg["img_indices"]]),
                torch.cat([batch_src["point_valid"],
                           batch_trg["point_valid"]]),
                n_domains=2, generator=state.rng)
        with span(net3d):
            if is_range:
                # back to back, each forward updating the running stats
                outs = [model_3d(bt["feats"], None, proj_in=bt["proj_in"],
                                 proj_xy=bt["proj_xy"], generator=state.rng)
                        for bt in (batch_src, batch_trg)]
                out3d = {k: torch.cat([o[k] for o in outs])
                         for k in outs[0] if k != "seg_logit_all"}
            else:
                feats = [batch_src["feats"], batch_trg["feats"]]
                if cat is not None:
                    feats.append(cat["feats"])
                out3d = model_3d(torch.cat(feats), plan,
                                 n_domains=2 if cat is None else 3,
                                 generator=state.rng)
        with span(loss_r):
            total, metrics = losses(out2d, out3d, batch_src, batch_trg, cat,
                                    b, p)
        with span(backward):
            total.backward()
        if mesh is not None:
            with span(allreduce), torch.no_grad():
                metrics = sync_replicas(mesh, state, metrics)
        with span(optim):
            state.opt_2d.step()
            state.opt_3d.step()
        with span(ema), torch.no_grad():
            # 0 before ema_start_iter (the teacher tracks the student), then
            # ema_alpha every ema_update_period steps and 1 in between
            active = state.step >= ema_start
            decay = (ema_alpha if active and state.step % ema_period == 0
                     else 1.0 if active else 0.0)
            for ema_p, params in ((state.ema_params_2d, state.params_2d),
                                  (state.ema_params_3d, state.params_3d)):
                e = list(ema_p.values())
                torch._foreach_mul_(e, decay)
                torch._foreach_add_(e, [params[k].detach() for k in ema_p],
                                    alpha=1.0 - decay)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    if not with_ema:
        return _step_span(train_step)
    ema_xm_prob = float(pc_mm.ema_xm_prob)

    def teacher_step(state: TrainState, batch_trg: dict):
        decode, *_, refine_r = TEACHER_STAGES
        with span(decode):
            batch = decode_batch({k: v for k, v in batch_trg.items()
                                  if is_ema_key(k)}, device)
            # one Bernoulli(ema_xm_prob) draw: the fused or the per-net labels
            u = torch.rand((), generator=state.rng, device=state.rng.device)
        probs_2d, probs_3d = teacher_forward(cfg, models, state, batch)
        with span(refine_r):
            with span("sync/teacher_draw"):
                use_xm = bool(u <= ema_xm_prob)
            pl_2d, pl_3d = teacher_labels(
                probs_2d, probs_3d, batch["ori_point_valid"].reshape(-1),
                batch["ema_map"], use_xm, num_classes)
            # the offline pseudo labels' wire dtype
            return pl_2d.to(torch.int16), pl_3d.to(torch.int16)

    def step_with_teacher(state: TrainState, batch_src: dict,
                          batch_trg: dict):
        pl_2d, pl_3d = teacher_step(state, batch_trg)
        trg = {k: v for k, v in batch_trg.items() if not is_ema_key(k)}
        trg["pseudo_label_2d"] = pl_2d
        trg["pseudo_label_3d"] = pl_3d
        src = {k: v for k, v in batch_src.items() if not is_ema_key(k)}
        return train_step(state, src, trg)

    step = _step_span(step_with_teacher)
    step.teacher_step = teacher_step
    step.student_step = _step_span(train_step)
    return step


def _step_span(fn):
    """``fn(state, ...)`` inside the step's outermost span,
    :data:`STEP_SPAN`, whose id is ``state.step``."""
    def step(state: TrainState, *batches):
        with span(STEP_SPAN, step=state.step):
            return fn(state, *batches)
    return step


def sync_replicas(mesh, state: TrainState, metrics: dict) -> dict:
    """The collectives of a data-parallel step, after its backward (JAX's
    ``pmean`` / ``psum`` in ``shard_map``): each net's gradients, then each
    net's floating batch-norm buffers, averaged as one flat bucket apiece;
    the float metrics averaged and the integer ones summed, one bucket per
    dtype. Returns the reduced metrics (detached copies)."""
    for params in (state.params_2d, state.params_3d):
        mesh_mod.all_reduce(mesh, [p.grad for p in params.values()
                                   if p.grad is not None], average=True)
    for stats in (state.batch_stats_2d, state.batch_stats_3d):
        mesh_mod.all_reduce(mesh, [b for b in stats.values()
                                   if b.is_floating_point()], average=True)
    out = {k: v.detach().clone() for k, v in metrics.items()}
    buckets = {}
    for v in out.values():
        buckets.setdefault(v.dtype, []).append(v)
    for dtype, tensors in buckets.items():
        mesh_mod.all_reduce(mesh, tensors, average=dtype.is_floating_point)
    return out


# the torch optimizers' per-parameter state behind each optax slot
_MOMENTS = {"Adam": (("mu", "exp_avg"), ("nu", "exp_avg_sq")),
            "SGD": (("trace", "momentum_buffer"),)}


def _optimizer_to_flax(spec: OptimizerSpec, opt: ScheduledOptimizer,
                       module: nn.Module, params: dict) -> dict:
    """One net's optimizer state in the JAX package's flattened optax names
    (:meth:`OptimizerSpec.optax_slots`), moments in the flax layout. A
    parameter the optimizer has not stepped yet (no state), and SGD's trace
    at momentum 0 (which carries nothing to the next update), are zeros,
    as optax's are before a first update."""
    slots = spec.optax_slots()
    out = {}
    for slot, key in _MOMENTS[spec.kind]:
        moment = {}
        for name, p in params.items():
            v = opt.optimizer.state.get(p, {}).get(key)
            moment[name] = torch.zeros_like(p) if v is None else v
        for name, arr in weights.to_flax(module, moment).items():
            out[slots[slot] + "." + name] = arr
    count = np.asarray(opt.count, np.int32)
    if "count" in slots:
        out[slots["count"]] = count
    out[slots["schedule_count"]] = count.copy()
    return out


def _optimizer_from_flax(spec: OptimizerSpec, opt: ScheduledOptimizer,
                         module: nn.Module, params: dict, flat: dict) -> None:
    """Fill ``opt`` from the flattened optax state ``flat``: Adam's ``mu``/
    ``nu``/``count`` become each parameter's ``exp_avg``/``exp_avg_sq``/
    ``step``, SGD's trace its ``momentum_buffer``, and the schedule's count
    the update count that indexes the learning rate (set for the next
    update). A name that is not a slot, a missing name or a misshapen
    moment raises."""
    slots = spec.optax_slots()
    scalars = [s for s in ("count", "schedule_count") if s in slots]
    moments = {slot: {} for slot, _ in _MOMENTS[spec.kind]}
    for name, value in flat.items():
        slot = next((s for s in moments
                     if name.startswith(slots[s] + ".")), None)
        if slot is not None:
            moments[slot][name[len(slots[slot]) + 1:]] = value
        elif name not in (slots[s] for s in scalars):
            raise KeyError("optimizer state {} is not a slot of {} ({})"
                           .format(name, spec.kind, slots))
    missing = [slots[s] for s in scalars if slots[s] not in flat]
    if missing:
        raise KeyError("optimizer state lacks {}".format(missing))
    loaded = {slot: weights.from_flax(module, m, params)
              for slot, m in moments.items()}
    for name, p in params.items():
        state = {}
        if spec.kind == "Adam":
            state = {"step": torch.tensor(float(flat[slots["count"]]),
                                          dtype=torch.float32),
                     "exp_avg": loaded["mu"][name].to(p.device),
                     "exp_avg_sq": loaded["nu"][name].to(p.device)}
        elif spec.momentum != 0:
            state = {"momentum_buffer": loaded["trace"][name].to(p.device)}
        opt.optimizer.state[p] = state
    opt.count = int(flat[slots["schedule_count"]])
    for group in opt.optimizer.param_groups:
        group["lr"] = opt.lr_schedule(opt.count)


class CheckpointAdapter:
    """One net's part of a :class:`TrainState` as the JAX package's
    two-stream ``.pth`` checkpoints hold it (``mopa_tpu/train/trainer.py::
    CheckpointAdapter``; reference ``train_xmuda_mopa.py:140-155``), for a
    ``common.checkpoint.Checkpointer``.

    ``which`` ("2d" or "3d") picks the net. The stream holds ``model``
    (``params.<flax name>`` and ``batch_stats.<flax name>``), ``optimizer``
    (the flattened optax state, :func:`_optimizer_to_flax`), ``scheduler``
    (``{"last_epoch": step}``) and ``ema`` (the flax-named EMA
    parameters), all float32 numpy in the flax layout, so either package
    resumes from the other's files. Loading fills ``state`` in place and
    raises on a missing, extra or misshapen name; ``iteration`` becomes
    ``state.step``. As in the JAX package, the dropout generator is not
    saved: after a load ``state.rng`` is the one ``create_train_state``
    seeded."""

    def __init__(self, which: str, models: Models, state: TrainState):
        assert which in ("2d", "3d")
        self.which = which
        self.module = models.model_2d if which == "2d" else models.model_3d
        self.spec = models.tx_2d if which == "2d" else models.tx_3d
        self.state = state

    def _parts(self):
        s = self.state
        if self.which == "2d":
            return s.params_2d, s.batch_stats_2d, s.opt_2d, s.ema_params_2d
        return s.params_3d, s.batch_stats_3d, s.opt_3d, s.ema_params_3d

    def state_dict(self) -> dict:
        params, stats, opt, ema = self._parts()
        model = {"params." + k: v
                 for k, v in weights.to_flax(self.module, params).items()}
        model.update({"batch_stats." + k: v for k, v in
                      weights.to_flax(self.module, stats).items()})
        return {"model": model,
                "optimizer": _optimizer_to_flax(self.spec, opt, self.module,
                                                params),
                "scheduler": {"last_epoch": int(self.state.step)},
                "ema": weights.to_flax(self.module, ema)}

    def load_state_dict(self, ckpt: dict, resume_states: bool = True) -> dict:
        """Load ``ckpt`` (with ``resume_states`` also its EMA parameters and
        optimizer state); returns its other keys (``iteration``, the best
        metrics)."""
        params, _, opt, ema = self._parts()
        flat = {"params": {}, "batch_stats": {}}
        for name, value in ckpt.get("model", {}).items():
            group, _, leaf = name.partition(".")
            if group not in flat:
                raise KeyError("model variable {} is neither params. nor "
                               "batch_stats.".format(name))
            flat[group][leaf] = value
        weights.load_flax_state(self.module, flat["params"],
                                flat["batch_stats"])
        if resume_states and "ema" in ckpt:
            with torch.no_grad():
                for k, v in weights.from_flax(self.module, ckpt["ema"],
                                              ema).items():
                    ema[k].copy_(v)
        if resume_states and "optimizer" in ckpt:
            _optimizer_from_flax(self.spec, opt, self.module, params,
                                 ckpt["optimizer"])
        if "iteration" in ckpt:
            self.state.step = int(ckpt["iteration"])
        return {k: v for k, v in ckpt.items()
                if k not in ("model", "optimizer", "scheduler", "ema")}
