"""Model factory from config (PyTorch port of ``mopa_tpu/models/build.py``)."""

import torch

from mopa_tpu_torch.common.spans import span
from mopa_tpu_torch.models import serialize
from mopa_tpu_torch.models.spvcnn import NUM_LEVELS as SPVCNN_LEVELS
from mopa_tpu_torch.models.xmuda_arch import Net2DSeg, Net3DSeg


def compute_dtype(cfg) -> torch.dtype:
    """``TPU.COMPUTE_DTYPE`` (the reference's key): bfloat16 or float32."""
    name = cfg.get("TPU", {}).get("COMPUTE_DTYPE", "float32")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def plan_levels(cfg) -> int | None:
    """Levels of the 3D net's voxel plan: 5 for SPVCNN, one a stage of
    ``MODEL_3D.PTv3.enc_depths`` for PTv3, ``MODEL_3D.SCN.num_planes`` for
    SCN, None for SalsaNext (range images, no plan)."""
    if "SalsaNext" in cfg.MODEL_3D.TYPE:
        return None
    if "SPVCNN" in cfg.MODEL_3D.TYPE:
        return SPVCNN_LEVELS
    if _is_ptv3(cfg):
        return len(cfg.MODEL_3D.PTv3.enc_depths)
    return int(cfg.MODEL_3D.SCN.num_planes)


def _is_ptv3(cfg) -> bool:
    return cfg.MODEL_3D.TYPE.startswith("PTv3")


def point_feature_channels(cfg) -> int:
    """Channels of the 3D net's point features: SPVCNN's and PTv3's
    ``in_channels`` (xyz and intensity), else 1 (SCN's all-ones column)."""
    m3 = cfg.MODEL_3D
    if "SPVCNN" in m3.TYPE or _is_ptv3(cfg):
        return int(m3.get(m3.TYPE, {}).get("in_channels", 4))
    return 1


def plan_batch_keys(cfg) -> tuple:
    """Keys of a collated batch that the 3D net's plan stage reads even
    where a host-built plan is shipped: PTv3's points' ``coords``, which
    :func:`extend_plan` serializes; none for the other nets."""
    return ("coords",) if _is_ptv3(cfg) else ()


def extend_plan(cfg, plan, coords, samples: int | None):
    """``plan`` of ``samples`` scans (None: the monolithic plan of all the
    points) with what the 3D net adds to it in the plan stage, from the
    points' integer coordinates ``coords`` (a list of tensors of the
    :func:`plan_batch_keys` key, concatenated; read by PTv3 alone): PTv3's
    serialization (``plan.serial``: curve orders, patch layouts, the stem's
    map; span ``plan/serialize``). Other nets' plans are returned as
    they are."""
    if not _is_ptv3(cfg):
        return plan
    if samples is None:
        raise ValueError("PTv3 needs per-sample plans (sample_size)")
    m3 = cfg.MODEL_3D.PTv3
    with span("plan/serialize", trace=False):
        return plan._replace(serial=serialize.serialize(
            plan, torch.cat([c.reshape(-1, 3) for c in coords]), samples,
            m3.enc_patch_size, m3.order))


def build_model_2d(cfg, generator=None) -> Net2DSeg:
    """The dense ``seg_logit_all`` head is on exactly when the SAM
    consistency loss reads it (``TRAIN.PC_MM.lambda_sam_cons`` > 0), as in
    the reference's ``build_model_2d``; the depth head with
    ``TRAIN.DEPTH_PRED``."""
    output_all = float(cfg.TRAIN.PC_MM.lambda_sam_cons) > 0
    return Net2DSeg(num_classes=cfg.MODEL_2D.NUM_CLASSES,
                    dual_head=cfg.MODEL_2D.DUAL_HEAD,
                    backbone_2d=cfg.MODEL_2D.TYPE,
                    compute_dtype=compute_dtype(cfg), generator=generator,
                    output_all=output_all,
                    depth_pred=bool(cfg.TRAIN.get("DEPTH_PRED", False)))


def build_model_3d(cfg, generator=None) -> Net3DSeg:
    """``MODEL_3D.TYPE``'s net with its ``MODEL_3D.<TYPE>`` options
    (``pretrained`` is not read)."""
    kwargs = dict(cfg.MODEL_3D.get(cfg.MODEL_3D.TYPE, {}))
    kwargs.pop("pretrained", None)
    return Net3DSeg(num_classes=cfg.MODEL_3D.NUM_CLASSES,
                    dual_head=cfg.MODEL_3D.DUAL_HEAD,
                    backbone_3d=cfg.MODEL_3D.TYPE,
                    compute_dtype=compute_dtype(cfg), generator=generator,
                    **kwargs)
