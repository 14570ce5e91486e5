"""Model and voxel-plan set-up shared by the train and eval steps (PyTorch
port of the eval-path part of ``mopa_tpu/train/trainer.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from mopa_tpu_torch.models.build import build_model_2d, build_model_3d
from mopa_tpu_torch.models.scn_unet import (UNetPlan, build_unet_plan_batched,
                                            capacity_schedule)


def _num_levels(cfg) -> int:
    if cfg.MODEL_3D.TYPE != "SCN":
        raise NotImplementedError(
            "3D backbone {} not ported yet".format(cfg.MODEL_3D.TYPE))
    return int(cfg.MODEL_3D.SCN.num_planes)


def _capacities(cfg, n_points: int):
    """Per-level capacities; ``TPU.CAP_FACTORS`` overrides the built-in
    LiDAR-measured schedule."""
    factors = tuple(cfg.TPU.get("CAP_FACTORS", ())) if "TPU" in cfg else ()
    return capacity_schedule(n_points, _num_levels(cfg),
                             factors=factors or None)


def build_plan_from_batch(cfg, coords: torch.Tensor, valid_flat: torch.Tensor,
                          sample_size: int) -> UNetPlan:
    """Voxel plan for a flat (S*P, 3) batch of S scans of P points each,
    built per sample and stitched into the reference's flat layout. The
    points are sorted here whatever their order."""
    p = int(sample_size)
    s = coords.shape[0] // p
    return build_unet_plan_batched(coords.reshape(s, p, 3),
                                   valid_flat.reshape(s, p), _num_levels(cfg),
                                   capacities=_capacities(cfg, p))


class Models(NamedTuple):
    model_2d: nn.Module
    model_3d: nn.Module


def build_models(cfg, device="cuda", seed: int | None = None) -> Models:
    """Both nets with seeded random weights (``RNG_SEED`` unless ``seed``),
    on ``device`` (the GPU unless the caller asks for the CPU)."""
    gen = torch.Generator().manual_seed(
        int(cfg.RNG_SEED if seed is None else seed))
    model_2d = build_model_2d(cfg, generator=gen)
    model_3d = build_model_3d(cfg, generator=gen)
    return Models(model_2d.to(device), model_3d.to(device))
