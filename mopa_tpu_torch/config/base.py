"""Base experiment configuration tree.

Key-for-key compatible with the reference's yacs base config
(``mopa/common/config/base.py:10-133``) so that the shipped YAML experiment
files merge unchanged. TPU-specific knobs live under ``TPU`` and are additive
(they never collide with reference keys).
"""

from mopa_tpu_torch.common.config import CfgNode as CN

_C = CN()

# ---------------------------------------------------------------------------- #
# Resume
# ---------------------------------------------------------------------------- #
_C.RESUME_DIR = ""
_C.AUTO_RESUME = True
_C.RESUME_STATES = True
_C.RESUME_PATH = ""

# ---------------------------------------------------------------------------- #
# Model
# ---------------------------------------------------------------------------- #
_C.MODEL = CN()
_C.MODEL.TYPE = ""

# ---------------------------------------------------------------------------- #
# DataLoader
# ---------------------------------------------------------------------------- #
_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 12
_C.DATALOADER.DROP_LAST = True

# ---------------------------------------------------------------------------- #
# Optimizer (per-model 2D/3D groups, reference base.py:42-68)
# ---------------------------------------------------------------------------- #
_C.OPTIMIZER = CN()
_C.OPTIMIZER.MODEL_2D = CN()
_C.OPTIMIZER.MODEL_2D.TYPE = ""
_C.OPTIMIZER.MODEL_3D = CN()
_C.OPTIMIZER.MODEL_3D.TYPE = ""

_C.OPTIMIZER.MODEL_2D.BASE_LR = 0.001
_C.OPTIMIZER.MODEL_2D.WEIGHT_DECAY = 0.0
_C.OPTIMIZER.MODEL_3D.BASE_LR = 0.001
_C.OPTIMIZER.MODEL_3D.WEIGHT_DECAY = 0.0

_C.OPTIMIZER.MODEL_2D.SGD = CN()
_C.OPTIMIZER.MODEL_2D.SGD.momentum = 0.9
_C.OPTIMIZER.MODEL_2D.SGD.dampening = 0.0

_C.OPTIMIZER.MODEL_3D.SGD = CN()
_C.OPTIMIZER.MODEL_3D.SGD.momentum = 0.9
_C.OPTIMIZER.MODEL_3D.SGD.dampening = 0.0

_C.OPTIMIZER.MODEL_2D.Adam = CN()
_C.OPTIMIZER.MODEL_2D.Adam.betas = (0.9, 0.999)

_C.OPTIMIZER.MODEL_3D.Adam = CN()
_C.OPTIMIZER.MODEL_3D.Adam.betas = (0.9, 0.999)

# Some shipped configs (e.g. a2d2_semantic_kitti/baseline.yaml) set a flat
# OPTIMIZER.TYPE/BASE_LR that applies to both models.
_C.OPTIMIZER.TYPE = ""
_C.OPTIMIZER.BASE_LR = 0.001

# ---------------------------------------------------------------------------- #
# Scheduler
# ---------------------------------------------------------------------------- #
_C.SCHEDULER = CN()
_C.SCHEDULER.TYPE = ""
_C.SCHEDULER.MAX_ITERATION = 1
_C.SCHEDULER.CLIP_LR = 0.0

_C.SCHEDULER.StepLR = CN()
_C.SCHEDULER.StepLR.step_size = 0
_C.SCHEDULER.StepLR.gamma = 0.1

_C.SCHEDULER.MultiStepLR = CN()
_C.SCHEDULER.MultiStepLR.milestones = ()
_C.SCHEDULER.MultiStepLR.gamma = 0.1

# maskrcnn-benchmark-style warmup (reference lr_scheduler.py:6-51; unused by
# the shipped configs but part of the reference solver surface)
_C.SCHEDULER.WarmupMultiStepLR = CN()
_C.SCHEDULER.WarmupMultiStepLR.milestones = ()
_C.SCHEDULER.WarmupMultiStepLR.gamma = 0.1
_C.SCHEDULER.WarmupMultiStepLR.warmup_factor = 0.1
_C.SCHEDULER.WarmupMultiStepLR.warmup_steps = 1
_C.SCHEDULER.WarmupMultiStepLR.warmup_method = "linear"

# ---------------------------------------------------------------------------- #
# Train
# ---------------------------------------------------------------------------- #
_C.TRAIN = CN()
_C.TRAIN.BATCH_SIZE = 1
_C.TRAIN.CHECKPOINT_PERIOD = 0
_C.TRAIN.LOG_PERIOD = 200
_C.TRAIN.SUMMARY_PERIOD = 0
_C.TRAIN.MAX_TO_KEEP = 5
_C.TRAIN.FROZEN_PATTERNS = ()
_C.TRAIN.DEPTH_PRED = False

# ---------------------------------------------------------------------------- #
# Validation
# ---------------------------------------------------------------------------- #
_C.VAL = CN()
_C.VAL.BATCH_SIZE = 1
_C.VAL.PERIOD = 0
_C.VAL.LOG_PERIOD = 20
_C.VAL.METRIC = ""

# ---------------------------------------------------------------------------- #
# TPU-native additions (new; not present in the reference)
# ---------------------------------------------------------------------------- #
_C.TPU = CN()
# Static per-scan point budget (pad/truncate). 0 = derive from dataset defaults.
_C.TPU.POINT_BUDGET = 0
# Per-level voxel capacities as fractions of POINT_BUDGET; () = the built-in
# LiDAR-measured schedule (models/scn_unet.py::CAP_FACTORS). Sizing rule:
# capacities must hold the TRUE per-level unique-voxel counts (the bench's
# voxel_occupancy_max audits this) — overflow does not fail, but dropped
# voxels amputate a lexicographic (spatially biased) suffix of the scene.
_C.TPU.CAP_FACTORS = ()
# Compute dtype for the conv backbones ("bfloat16" or "float32").
_C.TPU.COMPUTE_DTYPE = "bfloat16"
# Training keys that a shipped YAML sets (configs/synthetic/mopa_smoke.yaml),
# kept so that it merges; the eval path reads neither.
# Data-parallel mesh axis size. 0 = use all local devices.
_C.TPU.DATA_PARALLEL = 0
# Per-image static SAM mask-id budget for the mask-pooled consistency loss.
_C.TPU.SAM_MASK_BUDGET = 64

# ---------------------------------------------------------------------------- #
# Misc
# ---------------------------------------------------------------------------- #
_C.OUTPUT_DIR = "@"
_C.RNG_SEED = 1
