"""Model factory from config (PyTorch port of ``mopa_tpu/models/build.py``)."""

import torch

from mopa_tpu_torch.models.spvcnn import NUM_LEVELS as SPVCNN_LEVELS
from mopa_tpu_torch.models.xmuda_arch import Net2DSeg, Net3DSeg


def compute_dtype(cfg) -> torch.dtype:
    """``TPU.COMPUTE_DTYPE`` (the reference's key): bfloat16 or float32."""
    name = cfg.get("TPU", {}).get("COMPUTE_DTYPE", "float32")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def plan_levels(cfg) -> int | None:
    """Levels of the 3D net's voxel plan: 5 for SPVCNN, ``MODEL_3D.SCN.
    num_planes`` for SCN, None for SalsaNext (range images, no plan)."""
    if "SalsaNext" in cfg.MODEL_3D.TYPE:
        return None
    if "SPVCNN" in cfg.MODEL_3D.TYPE:
        return SPVCNN_LEVELS
    return int(cfg.MODEL_3D.SCN.num_planes)


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
