#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``mopa_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Build the kernels (``mopa_tpu_torch/csrc/*.cu``, one nvcc per source, in
   parallel, for sm_90a, into ``mopa_tpu_torch/_build/``); print the card's
   name and power limit, the build seconds and the compiler's register/spill
   report. Per kernel of the three libraries, the registers, spills and
   stack frame (ptxas) and the tensor-core MMA instructions (``HMMA``/
   ``HGMMA`` in ``cuobjdump -sass``): every tensor-core kernel (K1 and
   ``d_feats``, ``d_w``, P2) must hold MMAs and spill nothing.
2. The gather probes at full size (``mopa_tpu_torch.tools.gather_micro``:
   24 x 16,384 slots, 48 bf16 lanes, 8 taps, Cout 16), with launch counts
   reset just before and read just after: P1 ``row_gather`` must equal its
   plain twin bit for bit, P2 ``gather_gemm`` be within max|err| <= 2e-2 *
   max|ref| of its twin; their times, their twins', the library calls'
   (``index_select``; indexing then ``matmul``) and their bounds, and the
   tiles P2 reads by its fallback. Then P2's edge cases, one launch each,
   under the same rule: the probe's ranks shuffled within each sample
   (every tile by the fallback), M not a multiple of the tile, D = 8 and
   128, out-of-range ranks in window and in fallback tiles (the twin reads
   them as zero rows, as the kernel does). Last, P2's device time per launch
   from a ``torch.profiler`` trace of 20 launches at the probe's shape.
3. Hold each conv kernel against its plain PyTorch twin on the card at every
   (Cin, Cout) of the SCN UNet's 14 submanifold convs: K1 (forward) on the
   plans of one and of eight seeded 16,384-point synthetic scans and on the
   fused plan of the shipped MoPA step (8 source + 8 target scans, then the
   8 VGI cat scans of 18,432 points); K2 (backward: ``d_feats`` and ``d_w``)
   on that plan. float32 to atol = rtol = 1e-4 (``d_w``:
   max|err| <= 1e-4 * max|ref|), bfloat16 to max|err| <= 2e-2 * max|ref|.
   One ``d_w`` shape runs twice and must give the same bits. bfloat16 runs
   the tensor-core route, float32 the CUDA-core route (``sparse_conv_cuda.
   route_for``). Time each with CUDA events (median of 20 launches after a
   warm-up), beside the twin, and compute the card's bound for the same work
   and the share of it reached (``bound_share`` = bound / time).
4. The eval step at full width (UNetResNet34 + SCN m=16, 7 planes, 10 classes,
   dual heads, 302x480 images, 16,384-point budget) in bfloat16: 3 requests
   of batch 1, then 1 of batch 8, with launch counts reset just before and
   read just after (14 K1 launches per 3D forward, no K2, all on the
   tensor-core route). Then the same
   requests with the plain twins swapped in: argmax agreement >= 0.99 on
   valid points and max probability delta <= 2e-2. One batch-1 request in
   float32 against the plain twins on the card and against the whole port on
   the CPU, to atol 1e-3. Per-request milliseconds and peak memory, 5 warm
   requests of each shape and one request traced by ``torch.profiler``.
5. The pre-EMA MoPA train step at full width in bfloat16 (8 source + 8
   target scans, Adam, SAM consistency on, VGI off): 3 steps on distinct
   batches with launch counts reset just before and read just after (per
   step 14 K1, 13 K2 ``d_feats``, 14 K2 ``d_w``, all on the tensor-core
   route), every loss finite; then 5
   steps on one repeated batch, after which ``total_loss`` must be below its
   first value. Then one float32 step of 1 + 1 scans three ways (kernels,
   plain twins on the card, the whole port on the CPU): losses to 1e-3
   relative, every gradient to 1e-3 of its tensor's largest. Then the median
   of 5 warm bfloat16 steps, the peak memory, and one step traced by
   ``torch.profiler`` split by ``trainer.TRAIN_STAGES``. Then this step and
   the same step on host-built plans (``hp_*`` keys), 5 each in turns, and
   one traced step of each: the plan stage and the device's idle share.
6. The EMA phase of the step at full width in bfloat16 (8 + 8 scans,
   ``ema_start_iter`` 0, the shipped ``ema_xm_prob`` 0.7; target batches
   carry the teacher's unaugmented view): 2 steps on distinct batches with
   launch counts reset just before and read just after (per step 28 K1, 14
   of them the teacher's, 13 K2 ``d_feats``, 14 K2 ``d_w``, all on the
   tensor-core route), every loss finite, the share of teacher labels kept; 5 student steps on one repeated
   batch with those teacher labels spliced in (one target for all 5), after
   which ``total_loss`` must be below its first value; the
   median of 5 warm steps and of 5 warm teacher calls, the peak memory, and
   one step traced by ``torch.profiler`` split by ``trainer.TEACHER_STAGES``
   and ``TRAIN_STAGES``. Then one float32 EMA step of 1 + 1 scans three ways,
   with ``ema_xm_prob`` forced to 0 and to 1: losses and gradients as in
   phase 5, and teacher labels equal on >= 99.9 % of the valid points. Then
   device-built against host-built plans in turns, as in phase 5 (the
   teacher's plan too).
7. The shipped MoPA step (``lambda_pc_mm`` 0.1: VGI on) before the EMA
   switch, its batches made as the reference's loader makes them: host VGI
   inserts one object per target scan (``data.vgi_host``) and every group's
   voxel plan is built on the host (``data.collate``: ``hp_*``,
   ``hp_cat_*``). The host work per batch pair in milliseconds by part, the
   capacity audit apart from the plan builder (it overlaps the step in a
   loader, so it is reported apart from the step), the most fixups
   a sample used against the budget, and the capacity audit (every level's
   true voxel count within its capacity). On the card, each decoded host
   plan equals ``build_unet_plan_batched`` on the same scans (ranks where
   a column has a neighbour). Then the checks of phase 5 on this step (3D
   net over 8 + 8 + 8 scans in three batch-norm domains, 389,104 level-0
   rows), with a finite ``pc_mm_loss`` and inserted points in every step,
   and its f32 1 + 1 + 1 step three ways.
8. The same with the EMA teacher (as phase 6; its plan from ``hp_ori_*``).
9. The shipped MoPA step fed by the port's loaders, as the train loop runs
   it: ``configs/synthetic/mopa_smoke.yaml`` at production shapes
   (:func:`smoke_cfg`), ``data.build.build_dataloader`` for each stream (4
   pool threads, host VGI and host plans on the producer thread), each
   wrapped in ``train.common.device_prefetch`` (pinned copies on a side
   stream; the source and, before the switch, the target without the EMA
   teacher's keys, the target without ``seg_label``); 10 iterations before
   the EMA switch, then both loaders rebuilt at the switch (the target's
   with the teacher's inputs) and 12 EMA iterations. In each phase the
   first iteration is set apart, the next ones are timed one by one (a
   synchronize after each), :data:`LOADER_WINDOW` run back to back with no
   synchronize (timed as a whole) and the last is traced. Per iteration:
   the exact K1/K2 launches (14/13/14, then 28/13/14), all on the
   tensor-core route, finite losses with ``pc_mm_loss``, inserted points,
   the EMA keys only on the EMA phase's target batches. The first iteration
   and the window's iterations are replayed on a second copy of the nets
   from the state they started from, fed ``device_batch`` of the same host
   batches: their losses must agree within :data:`LOSS_RTOL` (and the
   inserted points exactly), which a copy that the step read before it
   landed, or overwrote while the step read it, would break. At each
   phase's first iteration the prefetched batches also equal
   ``device_batch`` of their host batches bit for bit, the audited
   batches' true level counts are within capacity, and (before the switch)
   the first pair's decoded host plans equal the device build. Reported:
   the median wall ms per timed iteration beside phases 7 and 8's step,
   the window's ms per iteration, the loop's wait in ``next()`` per stream
   and the step inside the loop, the device's idle share and the
   ``train/decode`` span of the traced iteration, and each loader alone
   (batches/s, host ms per batch by part). An exception raised in a
   loader's pool must reach the consumer.
10. The training and eval drivers at full width, as a user runs them
   (:func:`driver_cfg`: :func:`smoke_cfg` with the EMA phase from iteration
   2, checkpoints every 2 iterations in a ring of 2, validation every 4 on
   a val stream of 8 scans at ``VAL.BATCH_SIZE`` 1, outputs in a temporary
   directory deleted at the end). Run A: ``train.common.train`` to
   iteration 4, with launch counts reset just before and read just after
   (K1 2 x 14 + 2 x 28 + 8 x 14 for the validation, ``d_feats`` 4 x 13,
   ``d_w`` 4 x 14, all on the tensor-core route), every logged loss finite
   with ``pc_mm_loss``, the checkpoints of iterations 2 and 4 with their
   pointers and rings, ``val_class_iou.xlsx`` read back with the logged
   IoUs, no loader or prefetch thread alive after ``train()`` returns.
   The resume: ``model_*_000004.pth`` loaded into fresh nets through
   ``trainer.CheckpointAdapter`` equals run A's returned state bit for bit
   (parameters, batch-norm buffers, EMA, Adam moments and steps, the update
   counts and next learning rates, ``step``). Run B: ``train()`` on the
   same directory to iteration 6 resumes at 4 in the EMA phase (its train
   loaders built at 4, the target's with the teacher's inputs; 2 x 28 K1
   launches and the validation's), ends at step 6 with
   ``model_*_000006.pth``, and the ring keeps 2 files. Then
   ``test.test.test_model`` on run B's checkpoints with a pseudo-label
   directory: its IoUs within 1e-3 of run B's last validation, one
   pseudo-label file per scan with the reference's keys. Then the four
   CLIs as subprocesses on ``configs/synthetic/mopa_smoke.yaml`` at its own
   size (``train_xmuda_mopa``, ``train_xmuda``, ``train_baseline`` without
   the target losses, then ``test.test`` on the MoPA run's directory):
   each must exit 0 and leave its log and checkpoints. Reported: each
   iteration's ``time`` meter and the medians without each loader build's
   first iteration, beside phase 9's loader-fed medians; each
   validation's seconds and ms per scan; checkpoint save ms and MiB per
   stream; load ms; each CLI's wall seconds.
11. Device VGI (the step's route when a VGI target batch ships no host
   cat plan): (a) ``ops.mixmatch.vgi_insert_batch`` on the card on phase
   7's raw target batches (8 scans of 16,384 points, one object of up to
   2,048 points), against the same function on the CPU with the same draws:
   every output agrees on >= 0.999 of its points (the differing points
   printed), its milliseconds beside phase 7's host VGI per batch; (b)
   ``ops.ground.estimate_ground`` on a 120,000-point 64-beam LiDAR-like
   scan, card against CPU, >= 0.999 agreement, milliseconds; (c) the shipped
   MoPA step through the device route, pre-EMA and EMA, 3 steps each with
   launch counts reset just before and read just after (K1 14 / 28 per
   step, ``d_feats`` 13, ``d_w`` 14), finite losses, inserted points, the
   ``train/vgi`` stage of a traced step, then the step on phase 7's and 8's
   host-VGI batches and on the device route in turns; (d) a target batch
   whose host plans overflow ``native_loader.FIXUP_BUDGET`` (patched to 1
   in this process) keeps its raw VGI inputs and trains through the device
   route.
12. Segment-Anything (``mopa_tpu_torch.models.sam``; plain PyTorch, no
   kernel of the repo), float32 with TF32 off: (a) ViT-H at its published
   widths (depth 32, dim 1280, 16 heads, window 14, global blocks 7, 15,
   23, 31) with seeded random weights built on the card, ``SAM.encode`` on
   one 1024 x 1024 image: 5 warm calls (ms, peak MiB), the FLOPs counted
   from the shapes and TFLOP/s, a traced call's busy and idle share; the
   embeddings finite and two calls bit-equal. (b) ``generate_mask_id_map``
   at 1024 with 32 x 32 prompts, mask budget 64, IoU above 0.7: ms per id
   map, split by the ``sam/encode``, ``sam/decode`` and ``sam/rasterize``
   ranges of a traced call, the masks written; then one id map with no
   IoU cut, which must hold a mask. Each id map and a seeded probability
   map give a finite ``losses.mask_cons_loss``. (c) ViT-B at
   1024, one set of weights and one image on the card and on the CPU:
   embeddings, decoded masks and IoU scores within 1e-3 x max|ref|, id maps
   (8 x 8 prompts, no IoU cut) equal on >= 0.999 of the pixels. (d) K1,
   K2 and P1/P2 launch 0 times in the phase.
13. The other 3D backbones and the depth head (:func:`backbone_phase`),
   their batches made as the train loader makes them (``SyntheticSCN`` at
   the KITTI geometry, ``collate_padded`` with host plans of the
   backbone's levels): (a) K1 and K2 at every conv shape of SPVCNN
   (:func:`spvcnn_conv_shapes`: the stem's 4 -> 32, the encoder's and the
   decoder's, among them the ones wider than 192 channels, K1 128 -> 256,
   256 -> 256 and 384 -> 256, ``d_feats`` at 384 and 256, ``d_w`` 384 x 256
   and 256 x 256) against their twins on the 5-level plan of 8 + 8 scans,
   in bfloat16 and float32 at phase 3's limits, each call's launches equal
   to its column blocks;
   (b) the SPVCNN xMUDA step at its published widths in bfloat16 (8 + 8
   scans, pseudo labels): launches per kernel and route (both routes: the
   decoder runs in float32, as in JAX), losses falling over 5 steps on one
   batch, the median of 5 warm steps, peak MiB, a traced step's busy and
   idle share; ``validate()`` on 4 val scans; the float32 1 + 1 step on the
   card and in the port on the CPU, losses within 1e-3; (c) the same for
   SalsaNext on 64 x 1024 range images, with no launch of the five kernels;
   (d) the shipped MoPA step (phase 7's target batch) with
   ``TRAIN.DEPTH_PRED`` and ``lambda_dp_src`` 0.1, its ms beside phase 7's
   and a finite ``depth_pred_loss``; (e) ``python -m
   mopa_tpu_torch.train.train_xmuda`` on ``mopa_smoke.yaml`` with
   ``MODEL_3D.TYPE`` SPVCNN and SalsaNext, exit 0 with its checkpoints.
14. The offline run around ``train()`` (:func:`offline_phase`): (a) and
   (b) run in a worker process of their own (``python3 chip_smoke.py
   --offline-worker <json>``, :func:`offline_worker`), started right after
   phase 3 and read after phase 13, since the convergence run takes ~13
   minutes of host-bound iterations; phases 4-13 run beside it. (a)
   ``mopa_tpu_torch.tools.convergence_check.run`` for 3,000 iterations
   (the learnable synthetic set, float32, the EMA switch at 2,100), with
   launch counts reset just before and read just after: every iteration
   launches K1 14 (28 in the EMA phase), ``d_feats`` 13 and ``d_w`` 14, all
   on the CUDA-core route, and the validation K1 14 per batch; val mIoU
   must clear the gate (2D 0.70, 3D 0.50, xM 0.70); printed: the mIoUs,
   the 3D per-class IoU, the 3D train IoU at 500 / 1000 / 2000 / 3000
   beside ``CONVERGENCE_r05.json``'s, the median iteration ms before and
   after the switch, the wall seconds, one traced step of each phase. (b)
   ``pslabel_update`` with ``entropy_fuse`` on the trained weights over the
   32 target train scans: one file per scan, as long as the scan, labels
   in [0, 10) and equal to the eval pass's argmax; the same weights on the
   CPU write labels equal on >= 0.999 of the points; ms per scan. (c)
   ``get_nuscenes_ground`` on 4 seeded 32-beam sweeps (5 float32 columns,
   34,720 points) listed in a pickle, on the card and on the CPU: ground
   masks equal on >= 0.999 of the points; ms per scan.
15. Data parallelism (``mopa_tpu_torch.parallel.mesh``, the JAX package's
   ``shard_map``-ed step) and the other plan forms (:func:`dp_phase`), run
   in the main process after phase 13, before it waits for phase 14's
   worker. (a) A one-rank NCCL mesh against ``mesh=None`` on the shipped
   MoPA step (phase 7's and 8's batches: bf16, 8 + 8 + 8 cat scans, SAM
   and VGI on), 3 pre-EMA and 2 EMA steps from one seed with deterministic
   algorithms: metrics and every tensor of the states (parameters,
   batch-norm buffers, EMA, Adam moments, the generator) bit-equal; the
   collectives and bytes a step, the step's ms with and without the mesh
   in turns. (b) Two ranks over gloo on the one card (NCCL takes one rank
   per card), each a process of its own (``python3 chip_smoke.py
   --dp-worker <json>``, :func:`dp_worker`; logs in
   ``chiprun_out/dp_rank<r>.log``): the shipped step at 4 + 4 scans a rank,
   3 pre-EMA and 1 EMA step, each with phase 7's (8's) launches on the
   tensor-core route and finite losses, the replicas' digests equal after
   every step (``all_gather``); the step and all-reduce ms and MB; one
   float32 step of 1 + 1 scans a rank on the card and on the CPU in the
   same processes, each rank on phase 7's float32 batch (losses 1e-3
   relative; each rank's own gradients, as they enter the all-reduce, 1e-3
   of their tensor's largest, and the averaged ones 1e-3 of the largest of
   the ranks' own);
   ``train()`` on ``mopa_smoke.yaml`` for 4 iterations
   across the EMA switch: rank 0 alone saves, both ranks load the last
   checkpoints into fresh nets bit for bit, and rank 0's validation equals
   one process's ``validate()`` on those weights. (c) The 3D net's float32
   eval forward over 8 scans of 16,384 points on the shipped batched plan,
   the monolithic plan (``nbr`` levels) and z-dense levels built as the
   JAX package's tests build them: logits within 1e-3 x max|ref| of the
   batched plan's, argmax agreement >= 0.999, K1 14 launches on the wide
   form and none on the others; each form's plan-build and forward ms.
   Then print the kernels line (JSON; ``route`` is the build route,
   ``cuda``, and ``kernel_route`` the conv kernels' route on the main path,
   whose launches are phase 7's), the card line, then ``{"ok": true,
   "device": {...}}`` as the last line.

Weights are random from a seed. Details go to ``chiprun_out/chip_smoke.json``.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import atexit
import importlib.util
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

POINT_BUDGET = 16384
IMAGE_SIZE = (480, 302)  # (W, H), the KITTI geometry of bench.py
NUM_CLASSES = 10
TRAIN_BATCH = 8          # TRAIN.BATCH_SIZE of xmuda_pl_mopa.yaml
M, NUM_PLANES = 16, 7
TIMED_LAUNCHES = 20
WARM_REQUESTS = 5
COUNTED_STEPS = 3
EMA_COUNTED_STEPS = 2
REPEATED_STEPS = 5
LOADER_PRE_EMA, LOADER_EMA = 10, 12  # loader-fed iterations around the switch
LOADER_WINDOW = 3  # iterations of each phase run with no synchronize
LOSS_RTOL = 1e-3   # a loader-fed loss against its replay on device_batch
LOADER_DRAIN = 6   # batches of each loader alone

K1 = "K1 submanifold_conv_fwd"
K2_DFEATS = "K2 submanifold_conv_bwd_dfeats"
K2_DW = "K2 submanifold_conv_bwd_dw"
P1 = "P1 row_gather"
P2 = "P2 gather_gemm"


def fail(msg: str) -> None:
    print("chip_smoke FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail("nvidia-smi failed: " + res.stderr)
    return res.stdout.strip().splitlines()[0]


def make_cfg(dtype: str, train: bool = False, batch_size: int = TRAIN_BATCH,
             ema_xm_prob=None, vgi: bool = False):
    """The shipped a2d2_semantic_kitti/xmuda_pl_mopa.yaml model pair, in code
    (no YAML on the card's machine); with ``train`` also its optimizer,
    schedule, loss weights and VGI settings, with VGI (``lambda_pc_mm``
    0.1) on only with ``vgi``. With ``ema_xm_prob`` the EMA phase from the
    first step (``ema_start_iter`` 0) with that fusion probability."""
    from mopa_tpu_torch.config.xmuda import cfg

    c = cfg.clone()
    c.MODEL_2D.TYPE = "UNetResNet34"
    c.MODEL_3D.TYPE = "SCN"
    c.MODEL_2D.NUM_CLASSES = NUM_CLASSES
    c.MODEL_3D.NUM_CLASSES = NUM_CLASSES
    c.MODEL_2D.DUAL_HEAD = True
    c.MODEL_3D.DUAL_HEAD = True
    c.MODEL_3D.SCN.m = M
    c.MODEL_3D.SCN.num_planes = NUM_PLANES
    c.TPU.POINT_BUDGET = POINT_BUDGET
    c.TPU.COMPUTE_DTYPE = dtype
    c.RNG_SEED = 0
    c.MODEL_2D.UNetResNet34.pretrained = False  # random weights from a seed
    if train:
        for net in (c.OPTIMIZER.MODEL_2D, c.OPTIMIZER.MODEL_3D):
            net.TYPE = "Adam"
            net.BASE_LR = 0.001
        c.SCHEDULER.TYPE = "MultiStepLR"
        c.SCHEDULER.MultiStepLR.gamma = 0.1
        c.SCHEDULER.MultiStepLR.milestones = (80000, 90000)
        c.SCHEDULER.MAX_ITERATION = 100000
        c.TRAIN.BATCH_SIZE = batch_size
        c.TRAIN.CLASS_WEIGHTS = [1.89090012, 2.0585112, 3.1970535, 3.1111633,
                                 1., 2.93751704, 1.92053733, 1.47886874,
                                 1.04654198, 1.78266561]
        c.TRAIN.XMUDA.lambda_xm_src = 0.1
        c.TRAIN.XMUDA.lambda_xm_trg = 0.01
        c.TRAIN.XMUDA.lambda_pl = 1.0
        c.TRAIN.PC_MM.lambda_pc_mm = 0.1 if vgi else 0.0
        c.TRAIN.PC_MM.z_disc = 0.3
        c.TRAIN.PC_MM.insert_mode = "ground"
        c.TRAIN.PC_MM.search_voxel_size = 0.5
        c.TRAIN.PC_MM.use_proj = True
        c.TRAIN.PC_MM.dis_range = (0, 15)
        c.TRAIN.PC_MM.lambda_sam_cons = 0.01
        c.TRAIN.PC_MM.ema_start_iter = 70000 if ema_xm_prob is None else 0
        c.TRAIN.PC_MM.ema_xm_prob = 0.7 if ema_xm_prob is None \
            else float(ema_xm_prob)
        c.TRAIN.PC_MM.ema_alpha_teacher = 0.999
        c.TRAIN.PC_MM.ema_update_period = 1
        c.TRAIN.PC_MM.use_class_weights = True
        # the shipped target: SemanticKITTI's 3D augmentation without the z
        # rotation (device VGI reads it)
        c.DATASET_TARGET.TYPE = "SemanticKITTISCN"
        c.DATASET_TARGET.SemanticKITTISCN.augmentation.rot_z = 0.0
    c.freeze()
    return c


def conv_shapes():
    """(name, level, Cin, Cout) of the 14 submanifold convs of one forward."""
    planes = [(i + 1) * M for i in range(NUM_PLANES)]
    out = [("stem", 0, 1, M)]
    for l, p in enumerate(planes):
        out.append(("l{}_conv1".format(l), l, p, p))
    for l, p in enumerate(planes[:-1]):
        out.append(("l{}_conv2".format(l), l, 2 * p, p))
    return out


def _check(kernel, tag, got, ref, elementwise: bool) -> tuple:
    """(max|err|, max|ref|, tolerance) after failing on a disagreement.
    float32: elementwise atol = rtol = 1e-4, or max|err| <= 1e-4 * max|ref|
    where the values are sums of a whole voxel range (``d_w``); bfloat16:
    max|err| <= 2e-2 * max|ref|."""
    import torch

    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    ref_max = float(ref.abs().max())
    if "bfloat16" in tag:
        ok, tol = err <= 2e-2 * ref_max, "max|err| <= 2e-2*max|ref|"
    elif elementwise:
        ok = bool(((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all())
        tol = "atol=rtol=1e-4"
    else:
        ok, tol = err <= 1e-4 * ref_max, "max|err| <= 1e-4*max|ref|"
    if not ok or not bool(torch.isfinite(got).all()):
        fail("{} disagrees with its plain twin at {}: max|err| {} "
             "(max|ref| {}, {})".format(kernel, tag, err, ref_max, tol))
    return err, ref_max, tol


def kernel_phase(plans: dict, backward_plan: str, device) -> list:
    """Each kernel vs its plain twin at every conv shape of every plan and
    dtype: K1 on every plan, K2 on ``backward_plan``. A row per (kernel,
    plan, conv, dtype) with the error, the times and the bound."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for plan_name, plan in plans.items():
        for name, level, cin, cout in conv_shapes():
            rows += shape_rows(plan_name, name, plan.levels[level], cin, cout,
                               plan_name == backward_plan, gen, device)
    return rows


def shape_rows(plan_name: str, name: str, lv, cin: int, cout: int,
               backward: bool, gen, device,
               timed: int = TIMED_LAUNCHES) -> list:
    """K1 (and with ``backward`` K2's two kernels) against their plain twins
    on plan level ``lv`` at Cin -> Cout, in float32 and bfloat16: a row each
    with the error, the times (medians of ``timed`` calls), the bound, and
    the launches one call makes (its column blocks)."""
    import torch

    from mopa_tpu_torch.ops import sparse_conv as sc
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.tools import gather_micro as gm

    rows = []
    v = lv.valid.shape[0]
    codes = lv.sel.long()
    pairs = sum(int((((codes >> (2 * j)) & 3) != 3).sum()) for j in range(3))
    plan_bytes = 2 * v * 9 * 4
    # (tile, column) blocks the tensor-core conv kernel stages
    col_tiles = int(scc.tile_columns(lv.ranks, lv.sel, v).sum())
    for dtype in (torch.float32, torch.bfloat16):
        dt_name = str(dtype).split(".")[-1]
        tag = "{} {} {}".format(plan_name, name, dt_name)
        esz = torch.tensor([], dtype=dtype).element_size()
        # batch norm writes its bias into padding rows: no input row is
        # zero, padding included
        feats = torch.randn((v, cin), generator=gen, device=device).to(dtype)
        w = (torch.randn((27, cin, cout), generator=gen, device=device)
             * (2.0 / (27 * cin)) ** 0.5).to(dtype)
        g = torch.randn((v, cout), generator=gen, device=device).to(dtype)
        cases = [(K1, True,
                  lambda: scc.submanifold_conv_wide_cuda(feats, lv.ranks,
                                                         lv.sel, w),
                  lambda: sc.submanifold_conv_wide_ref(feats, lv.ranks,
                                                       lv.sel, w),
                  (v * cin + 27 * cin * cout + v * cout) * esz + plan_bytes)]
        if backward:
            cases += [
                (K2_DFEATS, True,
                 lambda: scc.submanifold_conv_wide_bwd_dfeats_cuda(
                     g, lv.ranks, lv.sel, w),
                 lambda: sc.submanifold_conv_wide_dfeats_ref(
                     g, lv.ranks, lv.sel, w),
                 (v * cout + 27 * cin * cout + v * cin) * esz + plan_bytes),
                (K2_DW, False,
                 lambda: scc.submanifold_conv_wide_bwd_dw_cuda(
                     g, feats, lv.ranks, lv.sel),
                 lambda: sc.submanifold_conv_wide_dw_ref(
                     g, feats, lv.ranks, lv.sel),
                 (v * cout + v * cin) * esz + 27 * cin * cout * 4
                 + plan_bytes)]
        for kernel, elementwise, kern, plain, nbytes in cases:
            scc.reset_launch_counts()
            got = kern()
            per_call = scc.launches[kernel]
            ref = plain()
            torch.cuda.synchronize()
            err, ref_max, tol = _check(kernel, tag, got, ref, elementwise)
            out_width = cin if kernel == K2_DFEATS else cout
            if per_call != len(scc.column_blocks(out_width)):
                fail("{} at {} launched {} times for {} output columns"
                     .format(kernel, tag, per_call, out_width))
            row = {
                "kernel": kernel, "plan": plan_name, "conv": name,
                "cin": cin, "cout": cout, "voxel_rows": v,
                "neighbour_pairs": pairs, "dtype": dt_name,
                "route": scc.route_for(dtype), "launches_per_call": per_call,
                "max_abs_err": err, "max_abs_ref": ref_max,
                "tolerance": tol,
                "ms": gm.median_ms(kern, timed, device),
                "plain_ms": gm.median_ms(plain, timed, device),
                "bytes_ms": nbytes / gm.HBM_BYTES_PER_S * 1e3,
                "ops_ms": 2 * cin * cout * pairs / gm.PEAK_FLOPS[dt_name]
                * 1e3}
            row["bound_share"] = max(row["bytes_ms"], row["ops_ms"]) \
                / row["ms"]
            if kernel != K2_DW:
                # the dense MMA work of the staged (tile, column) blocks:
                # 3 slots x all channels, pairs or not, per column block
                k_in = cin if kernel == K1 else cout
                tiles = [scc.conv_tile_shape(k_in, c1 - c0)
                         for c0, c1 in scc.column_blocks(out_width)]
                row["tile_ops_ms"] = (2 * col_tiles * scc.TILE_M
                                      * sum(kp * np_ for kp, np_ in tiles)
                                      / gm.PEAK_FLOPS["bfloat16"] * 1e3)
            if kernel == K2_DW and name == "l0_conv2":
                again = kern()
                row["same_bits_on_rerun"] = bool(torch.equal(got, again))
                if not row["same_bits_on_rerun"]:
                    fail("K2 d_w gave other bits on a rerun at " + tag)
            rows.append(row)
            print("{kernel} {plan} {conv} ({cin},{cout}) {dtype} [{route}, "
                  "{launches_per_call} launch(es) a call]: {ms:.4f} ms "
                  "(plain {plain_ms:.4f} ms, bound {b:.4f} ms, share "
                  "{bound_share:.3f}) max|err| {max_abs_err:.3g}".format(
                      b=max(row["bytes_ms"], row["ops_ms"]), **row),
                  flush=True)
    scc.reset_launch_counts()
    return rows


def tensor_core_routes(tag: str) -> dict:
    """The conv kernels' launch counts by route since the last reset; fails
    if a bfloat16 path sent any of them to the CUDA-core route."""
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc

    routes = {k: dict(v) for k, v in scc.routes.items()}
    off = {k: v for k, v in routes.items() if v[scc.CUDA_CORE]}
    if off:
        fail("{} launched conv kernels off the tensor-core route: {}".format(
            tag, off))
    return routes


# a kernel of the three libraries and its template arguments (int, then an
# optional bool) in a mangled name
_KERNEL_NAME = re.compile(r"(subm_conv_(?:dw_)?(?:(?:f32|tc)_kernel|reduce)"
                          r"|row_gather_kernel|gather_gemm_tc_kernel)"
                          r"(?:ILi(\d+)E(?:Lb([01])E)?)?")


def _kernel_name(mangled: str):
    m = _KERNEL_NAME.search(mangled)
    if m is None:
        return None
    args = [a for a in m.groups()[1:] if a is not None]
    return m.group(1) + ("<{}>".format(",".join(args)) if args else "")


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    found = [os.path.join(home, "bin", "cuobjdump"), shutil.which("cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        found.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    for path in found:
        if path and os.path.exists(path):
            return path
    fail("cuobjdump not found (CUDA toolkit or triton's copy)")


def kernel_report() -> dict:
    """Per kernel of the three libraries (the conv, ``d_w`` and gather
    sources): registers, spilled bytes and stack frame (ptxas's report, kept
    beside each library) and the tensor-core MMA instructions
    (``HMMA``/``HGMMA``) in its SASS (``cuobjdump -sass``). Fails if a
    tensor-core kernel (K1 and ``d_feats``, ``d_w``, P2) holds no MMA or
    spills."""
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc

    tool = _cuobjdump()
    report = {}
    for lib in scc.SOURCES:
        so = scc.library_path(lib)
        kernels = {}
        cur = None
        for line in so.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line) \
                or re.search(r"Function properties for (\S+)", line)
            if m:
                cur = _kernel_name(m.group(1))
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                kernels.setdefault(cur, {})["spill_bytes"] = \
                    int(m.group(1)) + int(m.group(2))
            m = re.search(r"(\d+) bytes stack frame", line)
            if m:
                kernels.setdefault(cur, {})["stack_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                kernels.setdefault(cur, {})["registers"] = int(m.group(1))
        res = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                             text=True, timeout=300)
        if res.returncode != 0:
            fail("cuobjdump -sass {} failed: {}".format(so, res.stderr))
        cur = None
        for line in res.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = _kernel_name(m.group(1))
                if cur is not None:
                    kernels.setdefault(cur, {}).setdefault("mma", 0)
                continue
            if cur is not None and re.search(r"\bHG?MMA\b", line):
                kernels[cur]["mma"] += 1
        tc = {k: v for k, v in kernels.items() if "_tc_kernel" in k}
        if not tc:
            fail("no tensor-core kernel found in {}".format(so.name))
        for name, info in tc.items():
            if not info.get("mma"):
                fail("{} holds no tensor-core MMA instruction".format(name))
            if info.get("spill_bytes", 1) != 0:
                fail("{} spills (or ptxas reported nothing): {}".format(
                    name, info))
        report[lib] = kernels
    return report


def plain_twins():
    """Patch the sparse conv's kernel dispatch to the plain twins: the
    autograd Function then runs K1's and K2's twins on CUDA tensors too."""
    from mopa_tpu_torch.ops import sparse_conv as sc

    stack = ExitStack()
    for name, twin in (("_conv_fwd", sc.submanifold_conv_wide_ref),
                       ("_conv_bwd_dfeats",
                        sc.submanifold_conv_wide_dfeats_ref),
                       ("_conv_bwd_dw", sc.submanifold_conv_wide_dw_ref)):
        stack.enter_context(mock.patch.object(sc, name, twin))
    return stack


def check_outputs(out, batch, tag: str) -> None:
    import torch

    b, p = batch["img_indices"].shape[:2]
    for name, t in zip(("probs_2d", "probs_3d"), out[:2]):
        if tuple(t.shape) != (b * p, NUM_CLASSES) or not bool(
                torch.isfinite(t).all()):
            fail("{} {}: bad shape {} or non-finite".format(tag, name,
                                                            tuple(t.shape)))
        if float((t.float().sum(-1) - 1).abs().max()) > 1e-3:
            fail("{} {}: rows do not sum to 1".format(tag, name))
    for name, t in zip(("seg_loss_2d", "seg_loss_3d"), out[2:]):
        if not bool(torch.isfinite(t)):
            fail("{} {} is not finite".format(tag, name))


def valid_mask(batch):
    import numpy as np

    p = batch["img_indices"].shape[1]
    return (np.arange(p)[None, :] < batch["num_points"][:, None]).reshape(-1)


def compare(a, b, batch, tag: str, *, atol=None, agree_min=None,
            delta_max=None) -> dict:
    import torch

    valid = torch.from_numpy(valid_mask(batch)).to(a[1].device)
    res = {}
    for name, x, y in (("2d", a[0], b[0]), ("3d", a[1], b[1])):
        x, y = x.float()[valid], y.to(x.device).float()[valid]
        delta = float((x - y).abs().max())
        agree = float((x.argmax(-1) == y.argmax(-1)).float().mean())
        res[name] = {"max_prob_delta": delta, "argmax_agreement": agree}
        if atol is not None and delta > atol:
            fail("{} probs_{}: max delta {} > {}".format(tag, name, delta,
                                                         atol))
        if delta_max is not None and delta > delta_max:
            fail("{} probs_{}: max delta {} > {}".format(tag, name, delta,
                                                         delta_max))
        if agree_min is not None and agree < agree_min:
            fail("{} probs_{}: argmax agreement {} < {}".format(
                tag, name, agree, agree_min))
    return res


def timed_call(fn, *args) -> tuple:
    """(result, host-clock ms, peak MiB) of one synchronised call."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, torch.cuda.max_memory_allocated() / 2 ** 20


def profile_call(fn, stages, top: int = 12) -> dict:
    """Device time by kernel name, the device's busy share, and each stage's
    times over one call traced by ``torch.profiler`` (tracing adds host
    overhead).

    The stages are ``record_function`` ranges the call marks. ``host_ms`` is
    the range on the host clock. A kernel belongs to the stage whose host
    range holds the runtime call that launched it (matched by the trace's
    correlation id), whichever thread made the call: autograd launches the
    backward from a thread of its own, while the main thread waits inside
    its range. ``kernels`` counts a stage's kernels, ``device_kernel_ms``
    sums them,
    ``device_span_ms`` spans its first to its last kernel on the card, and
    ``top_kernels_ms`` lists its largest kernels by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ranges = {name: [] for name in stages}
    launch_ns, kernels = {}, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                kernels.append((name, ev.start_ns(),
                                ev.start_ns() + ev.duration_ns(),
                                ev.correlation_id()))
        elif name in ranges:
            ranges[name].append((ev.start_ns(),
                                 ev.start_ns() + ev.duration_ns()))
        elif name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                              "cudaMemset")):
            launch_ns[ev.correlation_id()] = ev.start_ns()
    if not kernels:
        return {"device_time": "not measured (no device events traced)"}

    def stage_of(corr):
        t = launch_ns.get(corr)
        for name, spans in ranges.items():
            if t is not None and any(a <= t <= b for a, b in spans):
                return name
        return "(no stage)"

    per_stage = {}
    for name, s0, e0, corr in kernels:
        per_stage.setdefault(stage_of(corr), []).append((name, s0, e0))
    out_stages = {}
    for name in list(stages) + ["(no stage)"]:
        ks = per_stage.get(name, [])
        st = {"host_ms": sum(b - a for a, b in ranges.get(name, [])) / 1e6,
              "kernels": len(ks),
              "device_kernel_ms": sum(e - s for _, s, e in ks) / 1e6,
              "device_span_ms": (max(e for _, _, e in ks)
                                 - min(s for _, s, _ in ks)) / 1e6
              if ks else 0.0}
        by_name = {}
        for kname, s0, e0 in ks:
            by_name[kname[:90]] = by_name.get(kname[:90], 0.0) + (e0 - s0)
        st["top_kernels_ms"] = [[k, ns / 1e6] for k, ns in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:6]]
        out_stages[name] = st
    busy, cur_s, cur_e, by_name = 0.0, None, None, {}
    for name, s, e, _ in sorted(kernels, key=lambda k: k[1]):
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    names = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e6,
            "device_idle_share": 1.0 - busy / 1e3 / wall_us,
            "device_kernel_ms_total": sum(by_name.values()) / 1e6,
            "stages": out_stages,
            "top_device_ms": [[n[:90], ns / 1e6] for n, ns in names[:top]]}


def eval_phase(batches_1, batch_8, device) -> dict:
    """Phase 3: the eval requests, their checks, times and profile."""
    from mopa_tpu_torch.data.utils.validate import STAGES, make_eval_step
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.train import trainer

    report = {}
    cfg = make_cfg("bfloat16")
    models = trainer.build_models(cfg, device=device, seed=0)
    step = make_eval_step(cfg, models)
    requests = [("batch1", b) for b in batches_1] + [("batch8", batch_8)]
    scc.reset_launch_counts()
    outs, req_report = [], []
    for tag, batch in requests:
        out, ms, peak = timed_call(step, batch)
        check_outputs(out, batch, tag)
        outs.append(out)
        req_report.append({"request": tag, "ms": ms, "peak_mib": peak})
        print("eval request {} bf16: {:.2f} ms, peak {:.0f} MiB".format(
            tag, ms, peak), flush=True)
    launches = dict(scc.launches)
    want = {K1: len(conv_shapes()) * len(requests), K2_DFEATS: 0, K2_DW: 0,
            P1: 0, P2: 0}
    if launches != want:
        fail("eval path launched {}, expected {}".format(launches, want))
    report["requests"] = req_report
    report["launches"] = launches
    report["routes"] = tensor_core_routes("eval path")

    with plain_twins():
        for (tag, batch), out, rr in zip(requests, outs, req_report):
            ref, ms, _ = timed_call(step, batch)
            rr["plain_ms"] = ms
            rr["vs_plain"] = compare(out, ref, batch, tag + " bf16",
                                     agree_min=0.99, delta_max=2e-2)
            print("  {} vs plain twin: {}".format(tag, rr["vs_plain"]))

    warm = {"batch1": [timed_call(step, batches_1[0])[1]
                       for _ in range(WARM_REQUESTS)],
            "batch8": [timed_call(step, batch_8)[1]
                       for _ in range(WARM_REQUESTS)]}
    report["warm_requests_ms"] = warm
    report["warm_batch1_median_ms"] = statistics.median(warm["batch1"])
    report["warm_batch8_median_ms"] = statistics.median(warm["batch8"])
    report["warm_batch8_scans_per_s"] = 8e3 / report["warm_batch8_median_ms"]
    print("warm eval requests bf16 (ms): batch1 {} batch8 {}; batch8 "
          "median {:.2f} ms = {:.1f} scans/s".format(
              warm["batch1"], warm["batch8"], report["warm_batch8_median_ms"],
              report["warm_batch8_scans_per_s"]))
    report["profile_batch8"] = profile_call(lambda: step(batch_8), STAGES)
    print("eval profile batch8 bf16: {}".format(report["profile_batch8"]))
    del models, step, outs

    cfg32 = make_cfg("float32")
    models32 = trainer.build_models(cfg32, device=device, seed=0)
    step32 = make_eval_step(cfg32, models32)
    b = batches_1[0]
    out32, ms32, _ = timed_call(step32, b)
    check_outputs(out32, b, "batch1 f32")
    with plain_twins():
        ref32 = step32(b)
    cpu_models = trainer.build_models(cfg32, device="cpu", seed=0)
    cpu32 = make_eval_step(cfg32, cpu_models)(b)
    report["f32"] = {
        "ms": ms32,
        "vs_plain": compare(out32, ref32, b, "batch1 f32", atol=1e-3),
        "vs_cpu": compare(out32, cpu32, b, "batch1 f32 vs cpu", atol=1e-3)}
    print("eval request batch1 f32: {:.2f} ms; vs plain {}; vs cpu {}".format(
        ms32, report["f32"]["vs_plain"], report["f32"]["vs_cpu"]))
    return report


def train_batches(n: int, batch_size: int, start: int,
                  with_ema: bool = False, with_vgi: bool = False) -> list:
    """``n`` (source, target) train batch pairs of ``batch_size`` scans; with
    ``with_ema`` the targets carry the EMA teacher's view, with ``with_vgi``
    the raw VGI inputs."""
    from mopa_tpu_torch.data import synthetic

    out = []
    for i in range(n):
        idx = start + i * batch_size
        out.append(tuple(synthetic.train_batch(
            batch_size, POINT_BUDGET, start_index=idx, image_size=IMAGE_SIZE,
            domain=d, num_classes=NUM_CLASSES,
            with_ema=with_ema and d == "target",
            with_vgi=with_vgi and d == "target")
            for d in ("source", "target")))
    return out


def timed_host_work(records: list):
    """Patch ``data.collate``'s host functions to append (plan prefix,
    "vgi" or "audit", milliseconds) to ``records`` per call. A plan's time
    holds its samples' capacity audits (``_true_level_nums``, recorded
    first), host VGI's holds its cat plan's."""
    from mopa_tpu_torch.data import collate

    stack = ExitStack()
    for name in ("_host_plan_batch", "_host_vgi_batch", "_true_level_nums"):
        def timed(*args, _real=getattr(collate, name), _name=name, **kw):
            t0 = time.perf_counter()
            out = _real(*args, **kw)
            tag = {"_host_plan_batch": lambda: args[4],
                   "_host_vgi_batch": lambda: "vgi",
                   "_true_level_nums": lambda: "audit"}[_name]()
            records.append((tag, (time.perf_counter() - t0) * 1e3))
            return out
        stack.enter_context(mock.patch.object(collate, name, timed))
    return stack


def host_ms(records) -> dict:
    """One batch pair's host work by part, from :func:`timed_host_work`:
    each plan group's builder time without its audit, host VGI without its
    cat plan, the capacity audits of all groups (``audit_ms``) and the whole
    (``total_ms``)."""
    names = iter(("plan_source_ms", "plan_target_ms", "plan_teacher_ms"))
    out = {"audit_ms": 0.0, "total_ms": 0.0}
    audit = cat = 0.0
    for tag, ms in records:
        if tag == "audit":
            audit += ms
            out["audit_ms"] += ms
            continue
        if tag == "vgi":
            out["vgi_ms"] = ms - cat
        else:
            out["plan_cat_ms" if tag == "hp_cat_" else next(names)] = \
                ms - audit
            audit = 0.0
        if tag == "hp_cat_":
            cat = ms
        else:
            out["total_ms"] += ms
    return out


def audit_host_plans(pairs, capacities) -> dict:
    """Fails unless every group of every pair carries its host plan (none
    overflowed the fixup budget) and every level's true voxel count
    (``_<prefix>true_nums``) is within its capacity. Returns the most
    fixups a sample used and the largest share of a capacity filled, per
    group."""
    import numpy as np

    from mopa_tpu_torch.data import native_loader

    fixups, fill = {}, {}
    for src, trg in pairs:
        groups = [(src, "hp_"), (trg, "hp_"), (trg, "hp_cat_")]
        if "ori_coords" in trg:
            groups.append((trg, "hp_ori_"))
        for batch, pre in groups:
            if pre + "rankn" not in batch:
                fail("no {}* plan: its fixups overflowed the budget of "
                     "{}".format(pre, native_loader.FIXUP_BUDGET))
            used = int((batch[pre + "fix"] >= 0).sum(axis=1).max())
            fixups[pre] = max(fixups.get(pre, 0), used)
            caps = batch["_hp_cat_caps"] if pre == "hp_cat_" \
                else np.asarray(capacities)
            true = batch["_" + pre + "true_nums"]
            if (true > caps[None]).any():
                fail("{} plan: true voxel counts {} exceed the capacities {}"
                     .format(pre, true.tolist(), caps.tolist()))
            fill[pre] = max(fill.get(pre, 0.0), float((true / caps).max()))
    return {"most_fixups": fixups, "fixup_budget": native_loader.FIXUP_BUDGET,
            "largest_capacity_share": fill}


def mopa_batches(n: int, start: int, with_ema: bool, cfg,
                 batch_size: int = TRAIN_BATCH) -> tuple:
    """``n`` (source, target) pairs for the shipped MoPA step: the targets
    carry the raw VGI inputs (and with ``with_ema`` the teacher's view), and
    the loader's host work runs on every batch, timed: host VGI with its cat
    plan, and the plans of the source, target and teacher scans. Returns
    (pairs, report): the milliseconds per pair and the audit of
    :func:`audit_host_plans`."""
    from mopa_tpu_torch.data import synthetic

    host = synthetic.host_plan_settings(cfg, POINT_BUDGET, seed=start)
    pairs = train_batches(n, batch_size, start, with_ema, with_vgi=True)
    records, per_pair = [], []
    with timed_host_work(records):
        for src, trg in pairs:
            del records[:]
            synthetic.add_host_plans(src, host)
            synthetic.add_host_plans(trg, host)
            per_pair.append(host_ms(records))
    report = {"per_pair_ms": per_pair,
              **audit_host_plans(pairs, host["capacities"])}
    report["vgi_inserted"] = [int(t["vgi_inserted"].sum()) for _, t in pairs]
    return pairs, report


def _losses(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items() if v.dim() == 0}


def lift_bn_biases(models, value: float = 3.0) -> None:
    """Every batch-norm bias to ``value``. Float32 on the card and on the CPU
    differ by ~1e-6 in the forward; a ReLU input within that of 0 can land
    on either side of the kink and move the gradients of everything before
    it. Biases of 3 keep the ReLU inputs away from 0 (about 0.1 % stay
    masked), so the gradients can be compared at 1e-3."""
    import torch

    with torch.no_grad():
        for model in models:
            for mod in model.modules():
                if isinstance(getattr(mod, "scale", None), torch.nn.Parameter):
                    mod.bias.fill_(value)


def f32_step_three_ways(device, ema_xm_prob=None, vgi: bool = False) -> dict:
    """One float32 step of 1 + 1 scans: kernels, plain twins on the card, the
    whole port on the CPU. Dropout is off (the card's and the CPU's
    generators draw other masks). With ``ema_xm_prob`` (0 or 1, so the
    generators' bits do not decide the branch) an EMA step, whose teacher
    labels must agree on >= 99.9 % of the valid points. With ``vgi`` the
    shipped MoPA step: VGI on, 1 cat scan, host-built plans."""
    import torch

    from mopa_tpu_torch.train import trainer

    ema = ema_xm_prob is not None
    cfg = make_cfg("float32", train=True, batch_size=1,
                   ema_xm_prob=ema_xm_prob, vgi=vgi)
    if vgi:
        (src, trg), = mopa_batches(1, 400, ema, cfg, batch_size=1)[0]
    else:
        (src, trg), = train_batches(1, 1, 400, with_ema=ema)
    valid = torch.from_numpy(valid_mask(trg))
    labels = {}

    def run(dev, twins: bool):
        models = trainer.build_models(cfg, device=dev, seed=0)
        models.model_2d.net_2d.dropout_rate = 0.0
        lift_bn_biases(models[:2])
        state = trainer.create_train_state(cfg, models)
        step = trainer.make_train_step(cfg, models, with_pl=True,
                                       with_ema=ema)
        with plain_twins() if twins else ExitStack():
            if ema:
                labels[(str(dev), twins)] = [
                    t.cpu()[valid] for t in step.teacher_step(state, trg)]
            _, metrics = step(state, src, trg)
        grads = {}
        for net, model in (("2d", models.model_2d), ("3d", models.model_3d)):
            for name, prm in model.named_parameters():
                if prm.grad is None:
                    fail("f32 train step: no gradient for {} {}".format(
                        net, name))
                grads[net + ":" + name] = prm.grad.detach().float().cpu()
        return _losses(metrics), grads

    kern_l, kern_g = run(device, False)
    res = {"losses": kern_l}
    for tag, dev, twins in (("vs_plain", device, True), ("vs_cpu", "cpu",
                                                         False)):
        ref_l, ref_g = run(dev, twins)
        loss_rel = {k: abs(kern_l[k] - ref_l[k]) / max(abs(ref_l[k]), 1e-12)
                    for k in ref_l}
        bad = {k: r for k, r in loss_rel.items() if r > 1e-3}
        if bad or set(kern_l) != set(ref_l):
            fail("f32 train step {}: losses differ beyond 1e-3: {}".format(
                tag, bad))
        top = {net: max(float(g.abs().max()) for k, g in ref_g.items()
                        if k.startswith(net)) for net in ("2d", "3d")}
        worst, worst_name = 0.0, None
        for k, ref in ref_g.items():
            scale = float(ref.abs().max())
            err = float((kern_g[k] - ref).abs().max())
            if k.endswith((".conv.bias", ".tconv.bias")):
                # feeds a batch norm: the exact gradient is 0
                if max(err, scale) > 1e-3 * top[k.split(":")[0]]:
                    fail("f32 train step {}: {} not ~0: {}".format(
                        tag, k, err))
                continue
            if err > 1e-3 * scale:
                fail("f32 train step {}: gradient {} differs by {} (max|g| "
                     "{})".format(tag, k, err, scale))
            if err / max(scale, 1e-30) > worst:
                worst, worst_name = err / max(scale, 1e-30), k
        res[tag] = {"max_loss_rel": max(loss_rel.values()),
                    "max_grad_rel": worst, "max_grad_rel_tensor": worst_name}
        if ema:
            kern_pl, ref_pl = labels[(str(device), False)], labels[
                (str(dev), twins)]
            agree = [float((a == b).float().mean())
                     for a, b in zip(kern_pl, ref_pl)]
            res[tag]["teacher_label_agreement"] = agree
            if min(agree) < 0.999:
                fail("f32 EMA step {} (ema_xm_prob {}): teacher labels agree "
                     "on {} < 0.999 of the valid points".format(
                         tag, ema_xm_prob, agree))
        print("f32 {}{} step 1+1 {}: {}".format(
            "MoPA " if vgi else "",
            "EMA (ema_xm_prob {})".format(ema_xm_prob) if ema else "train",
            tag, res[tag]), flush=True)
    return res


def net3d_backward_ms(cfg, models, src, trg, device, n: int = 3) -> float:
    """Median CUDA-event time of the 3D net's backward alone (13 K2
    ``d_feats``, 14 K2 ``d_w`` and the autograd of its other ops) over the
    fused plan of one train batch pair, for the sum of its outputs."""
    import torch

    from mopa_tpu_torch.train import trainer
    from mopa_tpu_torch.train.common import decode_batch

    bs, bt = decode_batch(src, device), decode_batch(trg, device)
    b, p = bs["img_indices"].shape[:2]
    plan = trainer.build_plan_from_batch(
        cfg, torch.cat([bs["coords"], bt["coords"]]),
        torch.cat([bs["point_valid"], bt["point_valid"]]).reshape(-1), p,
        sample_domains=[0] * b + [1] * b)
    feats = torch.cat([bs["feats"], bt["feats"]])
    times = []
    for _ in range(n):
        out = models.model_3d(feats, plan, n_domains=2)
        loss = sum(v.float().sum() for v in out.values())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss.backward()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    models.model_3d.zero_grad(set_to_none=True)
    return statistics.median(times)


def compare_plans(host, dev, tag: str) -> dict:
    """Fails unless a decoded host plan equals the device build: every level
    field and point map with its dtype, the ranks where a column has a
    neighbour (an all-miss column, dz code 63, is read by no kernel: the
    decode holds the previous rank there, the build the sentinel)."""
    import torch

    dead = 0
    for l, (h, d) in enumerate(zip(host.levels, dev.levels)):
        for f in ("valid", "down_nbr", "f2c", "up_off", "sel", "dom",
                  "ranks"):
            a, b = getattr(h, f), getattr(d, f)
            if (a is None) != (b is None):
                fail("{} plan L{} {}: present in one plan only".format(
                    tag, l, f))
            if a is None:
                continue
            if f == "ranks":
                live = d.sel != 63
                dead += int((~live).sum())
                a, b = a[live], b[live]
            if a.dtype != b.dtype or not torch.equal(a, b):
                fail("{} plan L{} {}: host decode != device build".format(
                    tag, l, f))
    for f in ("point_inverse", "point_counts", "num_voxels", "point_end",
              "point_perm"):
        a, b = getattr(host, f), getattr(dev, f)
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail("{} plan {}: host decode != device build".format(tag, f))
    return {"rows": [lv.valid.shape[0] for lv in host.levels],
            "num_voxels": host.num_voxels.tolist(),
            "all_miss_columns": dead}


def host_plans_agree(src, trg, device) -> dict:
    """Phase 7's check on the card: each group's decoded host plan (the
    [source; target] scans, the teacher's view where the target has it, the
    cat scans) against ``build_unet_plan_batched`` on the same scans."""
    import torch

    from mopa_tpu_torch.models.scn_unet import (HOST_PLAN_KEYS,
                                                build_unet_plan_batched,
                                                capacity_schedule,
                                                plan_from_host_arrays)
    from mopa_tpu_torch.train.common import decode_batch

    bs, bt = decode_batch(src, device), decode_batch(trg, device)
    b, p = bs["img_indices"].shape[:2]
    n_cat = trg["cat_valid"].shape[1]
    groups = [("student", [bs, bt], "hp_", torch.cat(
        [bs["coords"], bt["coords"]]).reshape(2 * b, p, 3),
        torch.cat([bs["point_valid"], bt["point_valid"]]), p,
        [0] * b + [1] * b),
        ("cat", [bt], "hp_cat_", torch.from_numpy(trg["_cat_coords"]).to(
            device).reshape(b, n_cat, 3), bt["cat_valid"], n_cat, [2] * b)]
    if "hp_ori_rankn" in bt:
        groups.append(("teacher", [bt], "hp_ori_",
                       bt["ori_coords"].reshape(b, p, 3),
                       bt["ori_point_valid"], p, None))
    out = {}
    for tag, batches, pre, coords, valid, n, doms in groups:
        caps = capacity_schedule(n, NUM_PLANES)
        host = plan_from_host_arrays(
            {k: torch.cat([x[pre + k] for x in batches])
             for k in HOST_PLAN_KEYS}, caps, NUM_PLANES, sample_domains=doms)
        dev = build_unet_plan_batched(coords, valid, NUM_PLANES,
                                      capacities=caps, sample_domains=doms)
        out[tag] = compare_plans(host, dev, tag)
    print("host plans == device builds on the card: {}".format(out),
          flush=True)
    return out


def _stage(prof: dict, name: str) -> dict:
    st = prof.get("stages", {}).get(name, {})
    return {k: st.get(k) for k in ("host_ms", "device_span_ms",
                                   "device_kernel_ms")}


def host_plan_turns(step, state, src, trg, stages) -> dict:
    """The step on device-built plans (these batches) and on host-built
    plans (the same batches with ``hp_*`` / ``hp_ori_*`` added; VGI off),
    timed in turns (device, host, host, device, ...), then one traced step
    of each: what the host plans do to the plan stages and to the device's
    idle share."""
    from mopa_tpu_torch.data import synthetic
    from mopa_tpu_torch.models.scn_unet import capacity_schedule

    host = {"capacities": capacity_schedule(POINT_BUDGET, NUM_PLANES),
            "vgi": None}
    t0 = time.perf_counter()
    hsrc = synthetic.add_host_plans(dict(src), host)
    htrg = synthetic.add_host_plans(dict(trg), host)
    res = {"host_plan_build_ms": (time.perf_counter() - t0) * 1e3,
           "device": {"steps_ms": []}, "host": {"steps_ms": []}}
    batches = {"device": (src, trg), "host": (hsrc, htrg)}
    for i in range(2 * WARM_REQUESTS):
        kind = ("device", "host")[(i + i // 2) % 2]
        res[kind]["steps_ms"].append(
            timed_call(step, state, *batches[kind])[1])
    for kind in ("device", "host"):
        r = res[kind]
        r["median_ms"] = statistics.median(r["steps_ms"])
        prof = profile_call(lambda: step(state, *batches[kind]), stages)
        r["device_busy_ms"] = prof.get("device_busy_ms")
        r["device_idle_share"] = prof.get("device_idle_share")
        r["wall_ms"] = prof.get("wall_ms")
        for name in ("train/plan", "teacher/plan"):
            if name in stages:
                r[name] = _stage(prof, name)
    print("device vs host plans, in turns: {}".format(res), flush=True)
    return res


def train_phase(batches, device, with_ema: bool = False,
                vgi: bool = False) -> dict:
    """Phase 5 (pre-EMA) or, with ``with_ema``, phase 6 (the EMA phase at
    the shipped ``ema_xm_prob`` 0.7): the bf16 train step at full width over
    ``batches`` (one (source, target) pair per counted step), its launch
    counts, its falling loss, times, memory and profile, then the f32
    three-way check. The EMA phase also reads the share of teacher labels
    kept and times the teacher alone; its repeated-batch steps run the
    student step on one set of teacher labels, so the target stays fixed.
    Without VGI the step on device-built plans is then timed in turns with
    the step on host-built plans (:func:`host_plan_turns`). With ``vgi``
    phases 7 and 8: the shipped MoPA step, VGI on, over batches that carry
    host VGI's cat domain and host-built plans; every step must give a
    finite ``pc_mm_loss`` and insert objects."""
    import torch

    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.train import trainer
    from mopa_tpu_torch.train.common import is_ema_key

    tag = ("MoPA " if vgi else "") + ("EMA" if with_ema else "train")
    scans = "8+8+8 cat" if vgi else "8+8"
    report = {}
    cfg = make_cfg("bfloat16", train=True,
                   ema_xm_prob=0.7 if with_ema else None, vgi=vgi)
    models = trainer.build_models(cfg, device=device, seed=0)
    state = trainer.create_train_state(cfg, models)
    step = trainer.make_train_step(cfg, models, with_pl=True,
                                   with_ema=with_ema)

    scc.reset_launch_counts()
    steps = []
    for i, (src, trg) in enumerate(batches):
        (state, metrics), ms, peak = timed_call(step, state, src, trg)
        losses = _losses(metrics)
        if not all(torch.isfinite(torch.tensor(list(losses.values())))):
            fail("{} step {}: non-finite loss {}".format(tag, i, losses))
        if vgi and not ("pc_mm_loss" in losses and losses["vgi_inserted"] > 0):
            fail("{} step {}: no VGI loss or no inserted point: {}".format(
                tag, i, losses))
        steps.append({"ms": ms, "peak_mib": peak, "losses": losses,
                      "cm_src_3d_sum": int(metrics["cm_src_3d"].sum())})
        print("{} step {} bf16 {}: {:.2f} ms, peak {:.0f} MiB, {}".format(
            tag, i, scans, ms, peak, losses), flush=True)
    launches = dict(scc.launches)
    n, k = len(conv_shapes()), len(batches)
    # the teacher's 3D forward adds n K1 launches per step
    want = {K1: (2 if with_ema else 1) * n * k, K2_DFEATS: (n - 1) * k,
            K2_DW: n * k, P1: 0, P2: 0}
    if launches != want:
        fail("{} path launched {}, expected {}".format(tag, launches, want))
    report["steps"] = steps
    report["launches"] = launches
    report["routes"] = tensor_core_routes(tag + " path")
    print("{} path launches by route: {}".format(tag, report["routes"]))

    src, trg = batches[0]
    repeated, trg_repeated = step, trg
    if with_ema:
        valid = torch.from_numpy(valid_mask(trg)).to(device)
        pl_2d, pl_3d = step.teacher_step(state, trg)
        kept = [float(((t.long() >= 0) & valid).sum() / valid.sum())
                for t in (pl_2d, pl_3d)]
        report["teacher_labels_kept_share"] = kept
        print("teacher labels kept (2d, 3d) share of valid points: {}".format(
            kept))
        if not all(0.0 < x < 1.0 for x in kept):
            fail("teacher kept {} of the labels".format(kept))
        # the teacher reads the student's batch-norm statistics and the EMA
        # weights, which every step moves: its labels, taken once, are
        # spliced in so the repeated steps share one target
        trg_repeated = {k: v for k, v in trg.items() if not is_ema_key(k)}
        trg_repeated.update(pseudo_label_2d=pl_2d, pseudo_label_3d=pl_3d)
        repeated = step.student_step
    totals = []
    for _ in range(REPEATED_STEPS):
        state, metrics = repeated(state, src, trg_repeated)
        totals.append(float(metrics["total_loss"]))
    report["repeated_batch_total_loss"] = totals
    print("{} total_loss over {} steps on one batch: {}".format(
        tag, REPEATED_STEPS, totals))
    if not totals[-1] < totals[0]:
        fail("{} total_loss did not fall on a repeated batch: {}".format(
            tag, totals))

    warm = [timed_call(step, state, src, trg) for _ in range(WARM_REQUESTS)]
    report["warm_steps_ms"] = [w[1] for w in warm]
    report["warm_step_median_ms"] = statistics.median(report["warm_steps_ms"])
    report["peak_mib"] = max(w[2] for w in warm)
    print("warm {} steps bf16 {} (ms): {}; median {:.2f} ms; peak {:.0f} "
          "MiB".format(tag, scans, report["warm_steps_ms"],
                       report["warm_step_median_ms"], report["peak_mib"]),
          flush=True)
    stages = trainer.TRAIN_STAGES
    if with_ema:
        teacher = [timed_call(step.teacher_step, state, trg)
                   for _ in range(WARM_REQUESTS)]
        report["warm_teacher_ms"] = [t[1] for t in teacher]
        report["warm_teacher_median_ms"] = statistics.median(
            report["warm_teacher_ms"])
        report["teacher_peak_mib"] = max(t[2] for t in teacher)
        print("teacher alone (ms): {}; median {:.2f} ms; peak {:.0f} MiB"
              .format(report["warm_teacher_ms"],
                      report["warm_teacher_median_ms"],
                      report["teacher_peak_mib"]), flush=True)
        stages = trainer.TEACHER_STAGES + stages
    report["profile"] = profile_call(lambda: step(state, src, trg), stages,
                                     top=16)
    print("{} profile bf16 {}: {}".format(tag, scans, report["profile"]),
          flush=True)
    if not vgi:
        report["host_plan_turns"] = host_plan_turns(step, state, src, trg,
                                                    stages)
    if not (with_ema or vgi):
        report["net3d_backward_ms"] = net3d_backward_ms(cfg, models, src, trg,
                                                        device)
        print("3D net backward alone, bf16 8+8: {} ms".format(
            report["net3d_backward_ms"]), flush=True)
    del models, state, step, repeated
    torch.cuda.empty_cache()
    if with_ema:
        report["f32_three_ways"] = {
            "ema_xm_prob_{}".format(x): f32_step_three_ways(device, x, vgi)
            for x in (0, 1)}
    else:
        report["f32_three_ways"] = f32_step_three_ways(device, vgi=vgi)
    return report


def smoke_cfg():
    """``configs/synthetic/mopa_smoke.yaml`` at production shapes, as
    ``bench.py`` sizes it: 8 + 8 scans of 24,000 points (seeded
    ``SyntheticSCN``, 64 per stream) in 302x480 images, a 16,384-point
    budget, bfloat16, SCN m=16 with 7 planes, 4 pool threads per loader (the
    shipped config's), the shipped 64-id SAM budget, VGI on
    (``lambda_pc_mm`` 0.1, host VGI and host plans), and the EMA switch after
    :data:`LOADER_PRE_EMA` iterations."""
    from mopa_tpu_torch.config.xmuda import cfg

    c = cfg.clone()
    c.merge_from_file(str(ROOT / "configs" / "synthetic" / "mopa_smoke.yaml"))
    c.TRAIN.BATCH_SIZE = TRAIN_BATCH
    c.TPU.POINT_BUDGET = POINT_BUDGET
    c.TPU.COMPUTE_DTYPE = "bfloat16"
    c.TPU.SAM_MASK_BUDGET = 64
    c.MODEL_3D.SCN.m = M
    c.MODEL_3D.SCN.num_planes = NUM_PLANES
    for d in (c.DATASET_SOURCE.SyntheticSCN, c.DATASET_TARGET.SyntheticSCN):
        d.n_points = 24000
        d.image_size = IMAGE_SIZE
        d.length = 64
    c.DATALOADER.NUM_WORKERS = 4
    c.SCHEDULER.MAX_ITERATION = LOADER_PRE_EMA + LOADER_EMA
    c.TRAIN.PC_MM.ema_start_iter = LOADER_PRE_EMA
    c.RNG_SEED = 0
    c.freeze()
    return c


def _kept(loader, keep: list):
    """Iterate ``loader``, keeping its host batches in ``keep``."""
    for batch in loader:
        keep.append(batch)
        yield batch


def loader_streams(cfg, device, start: int, ema: bool, keep: dict):
    """(source, target) ``device_prefetch`` streams of fresh loaders at
    ``start``, as the train loop builds them: the source without the
    teacher's inputs; the target with them only in the EMA phase
    (``want_ema``), without ``seg_label``; the host batches of each go to
    ``keep``."""
    from mopa_tpu_torch.data.build import build_dataloader
    from mopa_tpu_torch.train.common import device_prefetch

    keep.update(source=[], target=[])
    src = build_dataloader(cfg, "train", "source", start_iteration=start,
                           want_ema=False)
    trg = build_dataloader(cfg, "train", "target", start_iteration=start,
                           want_ema=ema)
    return (device_prefetch(_kept(src, keep["source"]), device,
                            strip_ema=True),
            device_prefetch(_kept(trg, keep["target"]), device,
                            strip_ema=not ema, strip_keys=("seg_label",)))


def prefetched_equal(batch, host, device, ema: bool, target: bool) -> None:
    """Fails unless a prefetched batch equals, key by key and bit for bit,
    its host batch sent by a plain ``device_batch`` after a
    ``torch.cuda.synchronize()``."""
    import torch

    from mopa_tpu_torch.train.common import device_batch

    torch.cuda.synchronize()
    ref = device_batch(host, device, strip_ema=not (ema and target),
                       strip_keys=("seg_label",) if target else ())
    torch.cuda.synchronize()
    if set(batch) != set(ref):
        fail("prefetched batch keys {} != device_batch's {}".format(
            sorted(batch), sorted(ref)))
    for k, t in ref.items():
        if batch[k].dtype != t.dtype or not torch.equal(batch[k], t):
            fail("prefetched batch {} differs from device_batch".format(k))


def loader_parts(records) -> dict:
    """One batch's host milliseconds by part from :func:`timed_host_work`'s
    records: VGI without its cat plan, the plans without their audits, the
    audits."""
    out = {"vgi_ms": 0.0, "plans_ms": 0.0, "audit_ms": 0.0}
    audit = cat = 0.0
    for tag, ms in records:
        if tag == "audit":
            audit += ms
            out["audit_ms"] += ms
        elif tag == "vgi":
            out["vgi_ms"] += ms - cat
        else:
            out["plans_ms"] += ms - audit
            cat = ms if tag == "hp_cat_" else 0.0
            audit = 0.0
    return out


def loader_threads_end(timeout_s: float = 60.0) -> None:
    """Waits for every loader and prefetch thread to end; fails after
    ``timeout_s``."""
    import threading

    deadline = time.perf_counter() + timeout_s
    for t in threading.enumerate():
        if t.name.startswith(("mopa-loader", "mopa-prefetch")):
            t.join(max(deadline - time.perf_counter(), 0.0))
            if t.is_alive():
                fail("thread {} still runs after its consumer stopped"
                     .format(t.name))


def drain_loader(cfg, domain: str, ema: bool) -> dict:
    """One loader alone, without the step: :data:`LOADER_DRAIN` batches in
    batches/s (the pool's fill included), and each batch's host time by
    part: ``__getitem__`` on the pool, collate, and inside collate VGI, the
    plans and the capacity audit (first 2 batches)."""
    from mopa_tpu_torch.data import build

    loader = build.build_dataloader(cfg, "train", domain, want_ema=ema)
    per_batch, records, collate_ms = [], [], [0.0]
    real_load, real_collate = build.DataLoader._load_batch, \
        build.collate_padded

    def load(self, *args, **kw):
        del records[:]
        t0 = time.perf_counter()
        out = real_load(self, *args, **kw)
        row = {"total_ms": (time.perf_counter() - t0) * 1e3,
               "collate_ms": collate_ms[0]}
        row["getitem_ms"] = row["total_ms"] - row["collate_ms"]
        row.update(loader_parts(records))
        per_batch.append(row)
        return out

    def collate(*args, **kw):
        t0 = time.perf_counter()
        out = real_collate(*args, **kw)
        collate_ms[0] = (time.perf_counter() - t0) * 1e3
        return out

    with timed_host_work(records), \
            mock.patch.object(build.DataLoader, "_load_batch", load), \
            mock.patch.object(build, "collate_padded", collate):
        it = iter(loader)
        t0 = time.perf_counter()
        for _ in range(LOADER_DRAIN):
            next(it)
        elapsed = time.perf_counter() - t0
        it.close()
        loader_threads_end()
    return {"batches_per_s": LOADER_DRAIN / elapsed, "per_batch": per_batch}


def loader_exception_fails(device) -> str:
    """Fails unless an exception raised in a loader's pool reaches the
    consumer of ``device_prefetch`` (within 60 s)."""
    import threading

    import numpy as np

    from mopa_tpu_torch.data.build import DataLoader
    from mopa_tpu_torch.data.synthetic import SyntheticSCN
    from mopa_tpu_torch.train.common import device_prefetch

    class Failing(SyntheticSCN):
        def __getitem__(self, index):
            if index == 3:
                raise RuntimeError("sample 3 is unreadable")
            return super().__getitem__(index)

    loader = DataLoader(Failing(length=4, n_points=2000,
                                image_size=(64, 48)),
                        [np.arange(2), np.arange(2, 4)], 1024, num_workers=2)
    seen = []

    def consume():
        try:
            for _ in device_prefetch(loader, device):
                pass
        except RuntimeError as e:
            seen.append(str(e))

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(60)
    if not seen:
        fail("an exception in the loader's pool did not reach the consumer")
    return seen[0]


_STATE_DICTS = ("params_2d", "batch_stats_2d", "params_3d", "batch_stats_3d",
                "ema_params_2d", "ema_params_3d")


def state_snapshot(state) -> dict:
    """What a step's losses read of ``state``: copies of the nets' tensors
    and of the EMA parameters, the step count and the generator's state
    (the optimizers act after the losses)."""
    return {"tensors": {name: {k: v.detach().clone()
                               for k, v in getattr(state, name).items()}
                        for name in _STATE_DICTS},
            "step": state.step, "rng": state.rng.get_state()}


def load_snapshot(state, snap: dict) -> None:
    import torch

    with torch.no_grad():
        for name, tensors in snap["tensors"].items():
            dst = getattr(state, name)
            for k, v in tensors.items():
                dst[k].copy_(v)
    state.step = snap["step"]
    state.rng.set_state(snap["rng"])


def replay_agrees(twin, check: dict, device) -> float:
    """Replays one loader-fed iteration on the second nets (``twin``: state
    and steps) from the state it started from, fed ``device_batch`` of its
    host batches; fails unless every loss agrees within
    :data:`LOSS_RTOL` and ``vgi_inserted`` exactly. Returns the largest
    relative difference of a loss."""
    import torch

    from mopa_tpu_torch.train.common import device_batch

    ema = check["ema"]
    load_snapshot(twin["state"], check["snapshot"])
    src = device_batch(check["host_source"], device, strip_ema=True)
    trg = device_batch(check["host_target"], device, strip_ema=not ema,
                       strip_keys=("seg_label",))
    _, metrics = twin["steps"][ema](twin["state"], src, trg)
    ref = _losses(metrics)
    torch.cuda.synchronize()
    got, worst = check["losses"], 0.0
    for k, r in ref.items():
        if k == "vgi_inserted":
            if got[k] != r:
                fail("loader-fed iteration {}: {} inserted points, {} on "
                     "its replay".format(check["iteration"], got[k], r))
        elif "loss" in k:
            diff = abs(got[k] - r) / max(abs(r), 1e-6)
            worst = max(worst, diff)
            if diff > LOSS_RTOL:
                fail("loader-fed iteration {}: {} {} against {} on its "
                     "replay from device_batch".format(
                         check["iteration"], k, got[k], r))
    return worst


def check_iteration(i: int, losses: dict) -> None:
    import torch

    if not all(torch.isfinite(torch.tensor(list(losses.values())))):
        fail("loader-fed iteration {}: non-finite loss {}".format(i, losses))
    if not ("pc_mm_loss" in losses and losses["vgi_inserted"] > 0):
        fail("loader-fed iteration {}: no VGI loss or no inserted point: {}"
             .format(i, losses))


def loader_phase(device, prebuilt: dict) -> dict:
    """Phase 9: the shipped MoPA step fed by the port's loaders
    (``data.build``) through ``device_prefetch``, across the EMA switch, as
    the train loop runs it; ``prebuilt`` holds phases 7 and 8's reports."""
    import torch

    from mopa_tpu_torch.models.scn_unet import capacity_schedule
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.train import trainer
    from mopa_tpu_torch.train.common import is_ema_key

    cfg = smoke_cfg()
    report = {"exception": loader_exception_fails(device)}
    print("loader exception reached the consumer: {}".format(
        report["exception"]), flush=True)

    def nets():
        models = trainer.build_models(cfg, device=device, seed=0)
        return {"state": trainer.create_train_state(cfg, models),
                "steps": {ema: trainer.make_train_step(
                    cfg, models, with_pl=True, with_ema=ema)
                    for ema in (False, True)}}

    main, twin = nets(), nets()
    state, steps = main["state"], main["steps"]
    n = len(conv_shapes())
    keep, its, checks, streams, window = {}, [], [], None, {}
    total = LOADER_PRE_EMA + LOADER_EMA
    for i in range(total):
        ema = i >= LOADER_PRE_EMA
        j, length = (i - LOADER_PRE_EMA, LOADER_EMA) if ema \
            else (i, LOADER_PRE_EMA)
        first, traced = j == 0, j == length - 1
        windowed = length - 1 - LOADER_WINDOW <= j < length - 1
        if first:
            if streams is not None:
                for s in streams:
                    s.close()
            streams = loader_streams(cfg, device, i, ema, keep)
        step = steps[ema]
        scc.reset_launch_counts()
        if not windowed:
            torch.cuda.synchronize()
        held = {}

        def iteration():
            t0 = time.perf_counter()
            held["src"] = next(streams[0])
            t1 = time.perf_counter()
            held["trg"] = next(streams[1])
            t2 = time.perf_counter()
            held["out"] = step(held["state"], held["src"], held["trg"])
            if not windowed:
                torch.cuda.synchronize()
            t3 = time.perf_counter()
            if windowed:
                window.setdefault(ema, t0)
            return {"ms": (t3 - t0) * 1e3, "wait_source_ms": (t1 - t0) * 1e3,
                    "wait_target_ms": (t2 - t1) * 1e3,
                    "step_ms": (t3 - t2) * 1e3}

        snapshot = state_snapshot(state) if first or windowed else None
        held["state"] = state
        row = {"iteration": i, "ema": ema, "traced": traced,
               "windowed": windowed}
        if traced:
            stages = trainer.TRAIN_STAGES + (trainer.TEACHER_STAGES if ema
                                              else ())
            timing = {}
            prof = profile_call(lambda: timing.update(iteration()), stages)
            row.update(timing)
            row["profile"] = {k: prof.get(k) for k in (
                "wall_ms", "device_busy_ms", "device_idle_share")}
            row["profile"]["train/decode"] = _stage(prof, "train/decode")
        else:
            row.update(iteration())
        state, metrics = held["out"]
        src, trg = held["src"], held["trg"]
        launches = dict(scc.launches)
        want = {K1: (2 if ema else 1) * n, K2_DFEATS: n - 1, K2_DW: n,
                P1: 0, P2: 0}
        if launches != want:
            fail("loader-fed iteration {} launched {}, expected {}".format(
                i, launches, want))
        tensor_core_routes("loader-fed iteration {}".format(i))
        # the teacher's inputs ride the target stream of the EMA phase only
        if any(map(is_ema_key, src)) or ema != any(map(is_ema_key, trg)) \
                or (ema and not ("hp_ori_rankn" in trg and "ema_map" in trg)):
            fail("loader-fed iteration {} (EMA phase {}): source keys {}, "
                 "target keys {}".format(i, ema, sorted(src), sorted(trg)))
        if snapshot is not None:
            checks.append({"iteration": i, "ema": ema, "snapshot": snapshot,
                           "host_source": keep["source"][j],
                           "host_target": keep["target"][j],
                           "metrics": metrics, "row": row})
        if windowed:
            # no read of the card until the window ends: the losses wait
            del held, src, trg
            its.append(row)
            if j == length - 2:
                torch.cuda.synchronize()
                ms = (time.perf_counter() - window.pop(ema)) * 1e3
                key = "window_ema" if ema else "window_pre_ema"
                report[key] = {"iterations": LOADER_WINDOW, "ms": ms,
                               "per_iteration_ms": ms / LOADER_WINDOW}
                print("loader-fed {}: {}".format(key, report[key]),
                      flush=True)
                for c in checks:
                    if c["row"]["windowed"] and "losses" not in c["row"]:
                        c["row"]["losses"] = _losses(c["metrics"])
                        check_iteration(c["iteration"], c["row"]["losses"])
            continue
        losses = row["losses"] = _losses(metrics)
        check_iteration(i, losses)
        if first:
            for name, batch, target in (("source", src, False),
                                        ("target", trg, True)):
                prefetched_equal(batch, keep[name][0], device, ema, target)
            pairs = list(zip(keep["source"][:2], keep["target"][:2]))
            row["audit"] = audit_host_plans(
                pairs, capacity_schedule(POINT_BUDGET, NUM_PLANES))
            if not ema:
                row["plans_agree"] = host_plans_agree(*pairs[0], device)
        its.append(row)
        print("loader-fed iteration {} ({}): {:.2f} ms, waits source {:.2f} "
              "/ target {:.2f} ms, step {:.2f} ms, {}".format(
                  i, "EMA" if ema else "pre-EMA", row["ms"],
                  row["wait_source_ms"], row["wait_target_ms"],
                  row["step_ms"], losses), flush=True)
    for s in streams:
        s.close()
    del held, src, trg
    loader_threads_end()
    # the replays, on the second nets, after the loop
    for c in checks:
        c["losses"] = c["row"]["losses"]
        c["row"]["replay_max_rel_diff"] = replay_agrees(twin, c, device)
    report["replay_max_rel_diff"] = max(
        c["row"]["replay_max_rel_diff"] for c in checks)
    print("loader-fed losses vs their replays on device_batch: {} "
          "iterations, largest relative difference {:.3e}".format(
              len(checks), report["replay_max_rel_diff"]), flush=True)
    del checks
    report["iterations"] = its
    for ema, key, ref in ((False, "pre_ema", "mopa"), (True, "ema",
                                                       "mopa_ema")):
        rows = [r for r in its if r["ema"] == ema][1:]
        timed = [r for r in rows if not (r["traced"] or r["windowed"])]
        traced = [r for r in rows if r["traced"]][0]
        report[key] = {
            "timed_iterations": len(timed),
            "iteration_median_ms": statistics.median(r["ms"] for r in timed),
            "window_per_iteration_ms": report["window_" + key][
                "per_iteration_ms"],
            "wait_source_median_ms": statistics.median(
                r["wait_source_ms"] for r in timed),
            "wait_target_median_ms": statistics.median(
                r["wait_target_ms"] for r in timed),
            "wait_target_window_median_ms": statistics.median(
                r["wait_target_ms"] for r in rows if r["windowed"]),
            "step_in_loop_median_ms": statistics.median(
                r["step_ms"] for r in timed),
            "prebuilt_step_median_ms": prebuilt[ref]["warm_step_median_ms"],
            "device_idle_share": traced["profile"]["device_idle_share"],
            "device_busy_ms": traced["profile"]["device_busy_ms"],
            "decode": traced["profile"]["train/decode"],
            "prebuilt_decode": _stage(prebuilt[ref]["profile"],
                                      "train/decode")}
        print("loader-fed {}: {}".format(key, report[key]), flush=True)
    del main, twin, state, steps
    torch.cuda.empty_cache()
    report["drain"] = {
        "source": drain_loader(cfg, "source", False),
        "target": drain_loader(cfg, "target", False),
        "target_ema": drain_loader(cfg, "target", True)}
    for name, d in report["drain"].items():
        print("loader {} alone: {:.3f} batches/s; per batch (ms): {}".format(
            name, d["batches_per_s"], d["per_batch"]), flush=True)
    return report


DRIVER_A, DRIVER_B = 4, 6  # MAX_ITERATION of phase 10's runs A and B
DRIVER_EMA_START = 2
DRIVER_VAL_SCANS = 8
IOU_TOL = 1e-3  # test_model's IoUs against run B's last validation
CLI_TIMEOUT_S = 600
SMOKE_YAML = "configs/synthetic/mopa_smoke.yaml"


def driver_cfg(max_iteration: int):
    """Phase 10's config: :func:`smoke_cfg` (production shapes) run to
    ``max_iteration``, the EMA phase from iteration 2, checkpoints every 2
    iterations in a ring of 2, validation every 4 iterations on a val
    stream of :data:`DRIVER_VAL_SCANS` scans at the shipped
    ``VAL.BATCH_SIZE`` 1 (the target's ``SyntheticSCN`` length, so the
    target's train stream has these 8 scans too)."""
    c = smoke_cfg().clone()
    c.SCHEDULER.MAX_ITERATION = max_iteration
    c.TRAIN.PC_MM.ema_start_iter = DRIVER_EMA_START
    c.TRAIN.CHECKPOINT_PERIOD = 2
    c.TRAIN.MAX_TO_KEEP = 2
    c.TRAIN.LOG_PERIOD = 1
    c.VAL.PERIOD = 4
    c.VAL.BATCH_SIZE = 1
    c.DATASET_TARGET.SyntheticSCN.length = DRIVER_VAL_SCANS
    c.freeze()
    return c


class DriverProbe:
    """Records what ``train()`` and ``test_model()`` do, by wrapping the
    functions they call: each iteration's metrics and ``time`` meter
    (``MetricLogger.update`` with ``total_loss``), each checkpoint save
    (ms, MiB) and load (ms), each validation (s, scans) and each loader
    built (mode, domain, start, ``want_ema``)."""

    def __init__(self):
        self.iterations, self.saves, self.loads = [], [], []
        self.validations, self.loaders = [], []
        self._stack = ExitStack()

    def __enter__(self):
        import torch

        from mopa_tpu_torch.common import checkpoint, metric_logger
        from mopa_tpu_torch.data.utils import validate as val_mod
        from mopa_tpu_torch.test import test as test_mod
        from mopa_tpu_torch.train import common

        real_update = metric_logger.MetricLogger.update
        real_save = checkpoint.CheckpointerV2.save
        real_load = checkpoint.Checkpointer.load
        real_validate = val_mod.validate
        real_build = common.build_dataloader

        def update(logger, **kw):
            if "total_loss" in kw:
                self.iterations.append(
                    {k: float(v) for k, v in kw.items()})
            return real_update(logger, **kw)

        def save(ck, name, tag=True, **kw):
            t0 = time.perf_counter()
            path = real_save(ck, name, tag=tag, **kw)
            self.saves.append({"stream": ck.postfix, "name": name,
                               "ms": (time.perf_counter() - t0) * 1e3,
                               "mib": os.path.getsize(path) / 2 ** 20})
            return path

        def load(ck, path=None, resume=True, resume_states=True):
            t0 = time.perf_counter()
            out = real_load(ck, path, resume=resume,
                            resume_states=resume_states)
            torch.cuda.synchronize()
            if out:
                self.loads.append({"stream": ck.postfix,
                                   "ms": (time.perf_counter() - t0) * 1e3})
            return out

        def validate(cfg, models, loader, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_validate(cfg, models, loader, *a, **kw)
            torch.cuda.synchronize()
            self.validations.append({"s": time.perf_counter() - t0,
                                     "scans": len(loader.dataset)})
            return out

        def build_dataloader(cfg, mode="train", domain="source",
                             start_iteration=0, want_ema=None):
            self.loaders.append((mode, domain, start_iteration, want_ema))
            return real_build(cfg, mode, domain, start_iteration, want_ema)

        for target, name, fn in (
                (metric_logger.MetricLogger, "update", update),
                (checkpoint.CheckpointerV2, "save", save),
                (checkpoint.Checkpointer, "load", load),
                (val_mod, "validate", validate),
                (test_mod, "validate", validate),
                (common, "build_dataloader", build_dataloader)):
            self._stack.enter_context(mock.patch.object(target, name, fn))
        return self

    def __exit__(self, *exc):
        self._stack.close()


def driver_threads_alive() -> list:
    import threading

    return [t.name for t in threading.enumerate()
            if t.name.startswith(("mopa-loader", "mopa-prefetch"))]


def states_equal(a, b) -> int:
    """Fails unless two train states hold the same bits: every parameter,
    batch-norm buffer and EMA tensor, every optimizer moment and step, the
    update counts, the next learning rates and ``step``. Returns the
    number of tensors compared."""
    import torch

    if a.step != b.step:
        fail("resumed step {} != run A's {}".format(b.step, a.step))
    n = 0
    for net in ("2d", "3d"):
        for kind in ("params_", "batch_stats_", "ema_params_"):
            ta, tb = getattr(a, kind + net), getattr(b, kind + net)
            if set(ta) != set(tb):
                fail("resumed {} names differ".format(kind + net))
            for k in ta:
                n += 1
                if not torch.equal(ta[k], tb[k]):
                    fail("resumed {}{} differs from run A's".format(
                        kind + net, k))
        oa, ob = getattr(a, "opt_" + net), getattr(b, "opt_" + net)
        if oa.count != ob.count or oa.lr_schedule(oa.count) != [
                g["lr"] for g in ob.optimizer.param_groups][0]:
            fail("resumed optimizer {}: count {} / lr {} against run A's "
                 "{} / {}".format(net, ob.count,
                                  ob.optimizer.param_groups[0]["lr"],
                                  oa.count, oa.lr_schedule(oa.count)))
        pa, pb = getattr(a, "params_" + net), getattr(b, "params_" + net)
        for k in pa:
            sa = oa.optimizer.state[pa[k]]
            sb = ob.optimizer.state[pb[k]]
            for key in ("exp_avg", "exp_avg_sq", "step"):
                n += 1
                if not torch.equal(sa[key], sb[key]):
                    fail("resumed Adam {} of {} {} differs from run A's"
                         .format(key, net, k))
    return n


def check_run_files(run_dir: str, iterations, gone=()) -> None:
    for which in ("2d", "3d"):
        for name in ["model_{}_{:06d}.pth".format(which, i)
                     for i in iterations] + [
                "last_checkpoint_" + which, "checkpoint_ring_" + which]:
            if not os.path.exists(os.path.join(run_dir, name)):
                fail("train() left no {} in its directory".format(name))
        for i in gone:
            name = "model_{}_{:06d}.pth".format(which, i)
            if os.path.exists(os.path.join(run_dir, name)):
                fail("the checkpoint ring kept {}".format(name))


def run_cli(module: str, args: list, out_dir: str,
            log_name: str | None = None) -> dict:
    """One CLI as a subprocess from the checkout's root; fails on a
    non-zero exit. Its output goes to ``chiprun_out/cli_<log_name>.log``
    (the module's last name by default)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", module] + args, cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    log = ROOT / "chiprun_out" / "cli_{}.log".format(
        log_name or module.rsplit(".")[-1])
    log.parent.mkdir(exist_ok=True)
    log.write_text(res.stdout + "\n--- stderr ---\n" + res.stderr)
    if res.returncode != 0:
        fail("{} exited {}: {}".format(module, res.returncode,
                                       res.stderr[-3000:]))
    return {"wall_s": wall, "out_dir": out_dir, "stdout": res.stdout}


def cli_models_dir(out_dir: str) -> str:
    """The one models directory a train CLI made under ``OUTPUT_DIR``,
    with its log file and final checkpoints."""
    import glob

    dirs = glob.glob(os.path.join(out_dir, "models", "*"))
    if len(dirs) != 1:
        fail("a train CLI made {} model directories".format(dirs))
    run = dirs[0]
    if not glob.glob(os.path.join(run, "logs", "*_train_*.log")):
        fail("a train CLI left no log file in {}".format(run))
    check_run_files(run, (4,))
    return run


def driver_phase(device, report: dict) -> dict:
    """Phase 10: the training and eval drivers at full width, as a user
    runs them (:func:`driver_cfg`): run A, the bit-equal resume, run B,
    ``test_model`` and the four CLIs; ``report`` holds phase 9's."""
    import argparse
    import logging
    import tempfile

    import numpy as np
    import torch

    from mopa_tpu_torch.common.checkpoint import CheckpointerV2
    from mopa_tpu_torch.common.xlsx import read_xlsx_rows
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.test.test import test_model
    from mopa_tpu_torch.train import trainer
    from mopa_tpu_torch.train.common import train

    n = len(conv_shapes())
    out = {}
    tmp = tempfile.mkdtemp(prefix="mopa-driver-")
    run_dir = os.path.join(tmp, "run")
    os.makedirs(os.path.join(run_dir, "logs"))
    logger = logging.getLogger("chip_smoke.driver")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    handler = logging.FileHandler(os.path.join(run_dir, "logs",
                                               "driver.log"))
    logger.addHandler(handler)
    try:
        # -- run A: 2 pre-EMA and 2 EMA iterations, validation at 4
        with DriverProbe() as probe:
            scc.reset_launch_counts()
            t0 = time.perf_counter()
            state_a, eval_a = train(driver_cfg(DRIVER_A), logger, run_dir,
                                    "smoke", "mopa", device)
            torch.cuda.synchronize()
            out["run_a_s"] = time.perf_counter() - t0
            alive = driver_threads_alive()
            want = {K1: 2 * n + 2 * 2 * n + DRIVER_VAL_SCANS * n,
                    K2_DFEATS: 4 * (n - 1), K2_DW: 4 * n, P1: 0, P2: 0}
            if dict(scc.launches) != want:
                fail("run A launched {}, expected {}".format(
                    dict(scc.launches), want))
            tensor_core_routes("run A")
            if alive:
                fail("threads alive after train() returned: {}".format(alive))
            its_a = list(probe.iterations)
            val_a, saves_a = list(probe.validations), list(probe.saves)
        if len(its_a) != DRIVER_A:
            fail("run A logged {} iterations".format(len(its_a)))
        for i, m in enumerate(its_a):
            if "pc_mm_loss" not in m or not all(
                    np.isfinite(v) for v in m.values()):
                fail("run A iteration {}: {}".format(i + 1, m))
        check_run_files(run_dir, (2, 4))
        rows = read_xlsx_rows(os.path.join(run_dir, "val_class_iou.xlsx"))
        logged = [[k, round(v.overall_iou, 4)] for k, v in eval_a.items()]
        if [[r[0], r[-1]] for r in rows[1:]] != logged:
            fail("val_class_iou.xlsx rows {} against the logged IoUs {}"
                 .format(rows, logged))
        print("driver run A: {:.2f} s, launches {}, IoUs {}".format(
            out["run_a_s"], want, logged), flush=True)

        # -- the resume: model_*_000004 into fresh nets, bit for bit
        cfg_a = driver_cfg(DRIVER_A)
        models_r = trainer.build_models(cfg_a, device=device, seed=1)
        state_r = trainer.create_train_state(cfg_a, models_r)
        load_ms = {}
        for which in ("2d", "3d"):
            ck = CheckpointerV2(trainer.CheckpointAdapter(which, models_r,
                                                          state_r),
                                save_dir=run_dir, postfix="_" + which)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.load(os.path.join(run_dir, "model_{}_{:06d}.pth".format(
                which, DRIVER_A)), resume=False)
            torch.cuda.synchronize()
            load_ms[which] = (time.perf_counter() - t0) * 1e3
        out["resume"] = {"tensors_equal": states_equal(state_a, state_r),
                         "load_ms": load_ms}
        print("driver resume: {}".format(out["resume"]), flush=True)
        del models_r, state_r, state_a
        torch.cuda.empty_cache()

        # -- run B: resumes at 4 in the EMA phase, to 6
        with DriverProbe() as probe:
            scc.reset_launch_counts()
            t0 = time.perf_counter()
            state_b, eval_b = train(driver_cfg(DRIVER_B), logger, run_dir,
                                    "smoke", "mopa", device)
            torch.cuda.synchronize()
            out["run_b_s"] = time.perf_counter() - t0
            want = {K1: 2 * 2 * n + DRIVER_VAL_SCANS * n,
                    K2_DFEATS: 2 * (n - 1), K2_DW: 2 * n, P1: 0, P2: 0}
            if dict(scc.launches) != want:
                fail("run B launched {}, expected {}".format(
                    dict(scc.launches), want))
            tensor_core_routes("run B")
            its_b, loads_b = list(probe.iterations), list(probe.loads)
            val_b, saves_b = list(probe.validations), list(probe.saves)
            train_loaders = [ld for ld in probe.loaders if ld[0] == "train"]
        if train_loaders != [("train", "source", DRIVER_A, False),
                             ("train", "target", DRIVER_A, True)]:
            fail("run B built the train loaders {}".format(train_loaders))
        if state_b.step != DRIVER_B or len(its_b) != DRIVER_B - DRIVER_A:
            fail("run B ended at step {} after {} iterations".format(
                state_b.step, len(its_b)))
        check_run_files(run_dir, (DRIVER_A, DRIVER_B), gone=(2,))
        ring = open(os.path.join(run_dir, "checkpoint_ring_2d")).read()
        if [os.path.basename(p) for p in ring.split()] != [
                "model_2d_000004.pth", "model_2d_000006.pth"]:
            fail("the ring after run B: {}".format(ring))
        del state_b
        torch.cuda.empty_cache()
        print("driver run B: {:.2f} s, launches {}, train loaders {}".format(
            out["run_b_s"], want, train_loaders), flush=True)

        # -- test_model on run B's checkpoints, with pseudo-labels
        ps_dir = os.path.join(tmp, "pselab")
        args = argparse.Namespace(model_prefix=run_dir, ckpt2d="",
                                  ckpt3d="", pselab_dir=ps_dir)
        with DriverProbe() as probe:
            scc.reset_launch_counts()
            eval_t = test_model(driver_cfg(DRIVER_B), logger, args, device)
            val_t = list(probe.validations)
            out["test_model_launches"] = dict(scc.launches)
        ious = {k: (v.overall_iou, eval_b[k].overall_iou)
                for k, v in eval_t.items()}
        if set(ious) != set(eval_b) or any(
                abs(a - b) > IOU_TOL for a, b in ious.values()):
            fail("test_model IoUs {} against run B's last validation"
                 .format(ious))
        files = sorted(os.listdir(ps_dir))
        keys = {"probs_2d", "pseudo_label_2d", "probs_3d", "pseudo_label_3d"}
        if len(files) != DRIVER_VAL_SCANS or any(
                set(np.load(os.path.join(ps_dir, f),
                            allow_pickle=True).item()) != keys
                for f in files):
            fail("pseudo-label files {}".format(files))
        out["test_model_ious"] = ious
        print("driver test_model: IoUs (test_model, run B) {}; {} "
              "pseudo-label files".format(ious, len(files)), flush=True)

        # -- the four CLIs, as subprocesses, at mopa_smoke.yaml's own size
        clis = {}
        for name, module, extra in (
                ("mopa", "mopa_tpu_torch.train.train_xmuda_mopa", []),
                ("xmuda", "mopa_tpu_torch.train.train_xmuda", []),
                ("baseline", "mopa_tpu_torch.train.train_baseline",
                 ["TRAIN.XMUDA.lambda_xm_trg", "0",
                  "TRAIN.XMUDA.lambda_pl", "0"])):
            cli_out = os.path.join(tmp, "cli_" + name)
            clis[name] = run_cli(module, ["--cfg", SMOKE_YAML, "OUTPUT_DIR",
                                          cli_out] + extra, cli_out)
            clis[name]["models_dir"] = cli_models_dir(cli_out)
        clis["test"] = run_cli("mopa_tpu_torch.test.test", [
            "--cfg", SMOKE_YAML, "--model_prefix",
            clis["mopa"]["models_dir"]], "")
        if "2D+3D overall IOU" not in clis["test"]["stdout"]:
            fail("the test CLI printed no IoU")
        out["cli_wall_s"] = {k: v["wall_s"] for k, v in clis.items()}
        print("driver CLIs, wall s: {}".format(out["cli_wall_s"]),
              flush=True)
    finally:
        logger.removeHandler(handler)
        handler.close()
        shutil.rmtree(tmp, ignore_errors=True)

    # -- the figures
    def ms(rows):
        return [r["time"] * 1e3 for r in rows]

    pre, ema_a, ema_b = its_a[:DRIVER_EMA_START], its_a[DRIVER_EMA_START:], \
        its_b
    out["iteration_ms"] = {"pre_ema": ms(pre), "ema_run_a": ms(ema_a),
                           "ema_run_b": ms(ema_b)}
    # the first iteration after each loader build is the loaders' fill
    out["iteration_median_ms"] = {
        "pre_ema": statistics.median(ms(pre[1:])),
        "ema": statistics.median(ms(ema_a[1:]) + ms(ema_b[1:]))}
    loader = report["loader"]
    out["loader_fed_median_ms"] = {
        "pre_ema": loader["pre_ema"]["iteration_median_ms"],
        "ema": loader["ema"]["iteration_median_ms"]}
    vals = val_a + val_b + val_t
    out["validation"] = [{"s": v["s"], "ms_per_scan": v["s"] * 1e3
                          / v["scans"]} for v in vals]
    saves = {}
    for s_ in saves_a + saves_b:
        saves.setdefault(s_["stream"], []).append(s_)
    out["checkpoint_save"] = {
        k: {"saves": len(v), "median_ms": statistics.median(
            x["ms"] for x in v), "mib": max(x["mib"] for x in v)}
        for k, v in saves.items()}
    out["resume_load_ms"] = {x["stream"]: x["ms"] for x in loads_b}
    print("driver iteration ms: {}; medians {} beside phase 9's loader-fed "
          "{}".format(out["iteration_ms"], out["iteration_median_ms"],
                      out["loader_fed_median_ms"]), flush=True)
    print("driver validation: {}; checkpoint saves: {}; loads (run B) {}, "
          "(fresh nets) {}".format(out["validation"], out["checkpoint_save"],
                                   out["resume_load_ms"],
                                   out["resume"]["load_ms"]), flush=True)
    return out


def p2_inputs(s: int, v: int, m: int, d: int, seed: int, device,
              shuffled: bool = False):
    """Seeded P2 inputs on the card: a normal (s, v, d) bf16 table, ranks
    (s, 8m) in [0, v) sorted per sample (or in random order), a normal
    (8d, 16) bf16 weight."""
    import torch

    from mopa_tpu_torch.ops import gather

    g = torch.Generator(device=device).manual_seed(seed)
    tab = torch.randn((s, v, d), generator=g, device=device).to(
        torch.bfloat16)
    idx = torch.randint(0, v, (s, gather.TAPS * m), generator=g,
                        device=device, dtype=torch.int32)
    if shuffled:
        keys = torch.rand(idx.shape, generator=g, device=device)
        idx = torch.gather(idx, 1, torch.argsort(keys, dim=1))
    else:
        idx = torch.sort(idx, dim=1).values
    w = torch.randn((gather.TAPS * d, gather.COUT), generator=g,
                    device=device).to(torch.bfloat16)
    return tab, idx.contiguous(), w


def fallback_tiles(idx, v: int) -> dict:
    """The tiles P2 reads by its fallback (their span exceeds the window),
    counted on the host by the kernel's rule (``gather.tile_windows``), once
    the built kernel's tiling is found to be the one ``gather`` mirrors."""
    import ctypes

    from mopa_tpu_torch.ops import gather
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc

    tile_m, window_rows = ctypes.c_int(), ctypes.c_int()
    scc.build()["gather"].mopa_gather_gemm_tiling(ctypes.byref(tile_m),
                                                  ctypes.byref(window_rows))
    if (tile_m.value, window_rows.value) != (gather.TILE_M,
                                             gather.WINDOW_ROWS):
        fail("P2's kernel tiles {} rows with {}-row windows; ops/gather.py "
             "mirrors {} and {}".format(tile_m.value, window_rows.value,
                                        gather.TILE_M, gather.WINDOW_ROWS))
    fits = gather.tile_windows(idx, v)[2]
    return {"tiles": fits.numel(), "fallback": int((~fits).sum())}


def p2_edge_cases(device) -> list:
    """P2 beyond the probe's own data, each case one launch held to its
    plain twin by the bf16 rule: the probe's shape with its ranks shuffled
    within each sample (every tile takes the fallback), M not a multiple of
    the tile, D = 8 (K padded) and D = 128, and out-of-range ranks (zero
    rows in kernel and twin alike), sorted (window tiles) and shuffled
    (fallback tiles)."""
    import torch

    from mopa_tpu_torch.ops import gather
    from mopa_tpu_torch.tools import gather_micro as gm

    tab, idx, w = gm.make_inputs(device=device)
    g = torch.Generator(device=device).manual_seed(1)
    keys = torch.rand(idx.shape, generator=g, device=device)
    cases = [("probe shape, shuffled ranks", True, False,
              (tab, torch.gather(idx, 1, torch.argsort(keys, dim=1))
               .contiguous(), w))]
    del tab, idx, w
    for name, shape, shuffled, bad_ranks in (
            ("M = 1000, ragged last tile", (3, 1000, 1000, 48), False, False),
            ("D = 8 (K padded)", (4, 16384, 16384, 8), False, False),
            ("D = 24, ragged, shuffled", (3, 2000, 700, 24), True, False),
            ("D = 128", (4, 16384, 16384, 128), False, False),
            ("out-of-range ranks", (4, 16384, 16384, 48), False, True),
            ("out-of-range ranks, shuffled", (2, 4096, 4096, 48), True,
             True)):
        cases.append((name, shuffled, bad_ranks,
                      p2_inputs(*shape, seed=len(cases), device=device,
                                shuffled=shuffled)))
    rows = []
    for name, shuffled, bad_ranks, (tab, idx, w) in cases:
        s, v, d = tab.shape
        if bad_ranks:
            g = torch.Generator(device=device).manual_seed(7)
            hit = torch.rand(idx.shape, generator=g, device=device) < 0.01
            bad = torch.randint(-8, 8, idx.shape, generator=g, device=device,
                                dtype=torch.int32)
            bad = torch.where(bad < 0, bad, bad + v)  # [-8, 0) or [v, v + 8)
            idx = torch.where(hit, bad, idx).contiguous()
        got = gather.gather_gemm(tab, idx, w)
        ref = gather.gather_gemm_plain(tab, idx, w)
        torch.cuda.synchronize()
        row = {"case": name, "S": s, "V": v, "M": idx.shape[1] // gather.TAPS,
               "D": d, **fallback_tiles(idx, v),
               "max_abs_err": float((got.float() - ref.float()).abs().max()),
               "max_abs_ref": float(ref.float().abs().max()),
               "finite": bool(torch.isfinite(got.float()).all())}
        rows.append(row)
        n_bad = int(((idx < 0) | (idx >= v)).sum())
        print("P2 edge case {case} (S {S}, V {V}, M {M}, D {D}): fallback "
              "tiles {fallback}/{tiles}, out-of-range ranks {bad}, max|err| "
              "{max_abs_err:.3g} (max|ref| {max_abs_ref:.3g})".format(
                  bad=n_bad, **row), flush=True)
        if not (row["finite"]
                and row["max_abs_err"] <= 2e-2 * row["max_abs_ref"]):
            fail("P2 disagrees with its plain twin at {}: {}".format(name,
                                                                     row))
        if shuffled and row["fallback"] != row["tiles"]:
            fail("P2 edge case {}: not every tile took the fallback".format(
                name))
        if bad_ranks and not n_bad:
            fail("P2 edge case {}: no out-of-range rank".format(name))
        del tab, idx, w, got, ref
    return rows


def gather_phase(device) -> dict:
    """Phase 2: the port's gather probe at full size; P1 bit-exact against
    its twin, P2 within the bf16 rule; exact launch counts. Then P2's edge
    cases (one launch each)."""
    import math

    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.tools import gather_micro as gm

    scc.reset_launch_counts()
    res = gm.run_probes(n=TIMED_LAUNCHES, device=device)
    launches = dict(scc.launches)
    per_probe = gm.WARMUP + TIMED_LAUNCHES + 1
    want = {K1: 0, K2_DFEATS: 0, K2_DW: 0, P1: per_probe, P2: per_probe}
    if launches != want:
        fail("gather probe launched {}, expected {}".format(launches, want))
    res["launches"] = launches
    for line in gm.report_lines(res):
        print(line, flush=True)
    res["fused"].update(fallback_tiles(gm.make_inputs(device=device)[1],
                                       gm.V))
    print("P2 probe: fallback tiles {fallback}/{tiles}".format(
        **res["fused"]), flush=True)
    if not res["gather"]["bit_exact"]:
        fail("P1 differs from its plain twin: max|err| {}".format(
            res["gather"]["max_abs_err"]))
    fused = res["fused"]
    fused["tolerance"] = "max|err| <= 2e-2*max|ref|"
    if not fused["max_abs_err"] <= 2e-2 * fused["max_abs_ref"]:
        fail("P2 disagrees with its plain twin: max|err| {} (max|ref| {})"
             .format(fused["max_abs_err"], fused["max_abs_ref"]))
    if not all(math.isfinite(res[k]["checksum"]) for k in ("gather", "fused")):
        fail("gather probe checksums are not finite")
    res["p2_edge_cases"] = p2_edge_cases(device)
    want[P2] += len(res["p2_edge_cases"])
    fused["traced"] = p2_traced(device)
    want[P2] += TIMED_LAUNCHES
    if scc.launches != want:
        fail("P2's edge cases and trace launched {}, expected {}".format(
            dict(scc.launches), want))
    return res


def p2_traced(device) -> dict:
    """P2's device time per launch at the probe's shape from a
    ``torch.profiler`` trace of ``TIMED_LAUNCHES`` launches in a row: the
    kernel's own duration on the card, beside the probe's CUDA-event time
    of single calls, which holds the host's enqueue of each call too."""
    from mopa_tpu_torch.ops import gather
    from mopa_tpu_torch.tools import gather_micro as gm

    tab, idx, w = gm.make_inputs(device=device)
    traced = profile_call(lambda: [gather.gather_gemm(tab, idx, w)
                                   for _ in range(TIMED_LAUNCHES)], ())
    ms = [t for name, t in traced.get("top_device_ms", [])
          if "gather_gemm_tc_kernel" in name]
    res = {"launches": TIMED_LAUNCHES,
           "device_ms_per_launch": sum(ms) / TIMED_LAUNCHES if ms
           else "not measured (no P2 kernel in the trace)",
           "wall_ms": traced.get("wall_ms"),
           "device_idle_share": traced.get("device_idle_share")}
    print("P2 traced: {} launches in a row, device ms per launch {}, wall "
          "{} ms, device idle share {}".format(
              TIMED_LAUNCHES, res["device_ms_per_launch"], res["wall_ms"],
              res["device_idle_share"]), flush=True)
    return res


def kernel_entry(kernel: str, rows: list, launches: int, source: str,
                 replaces: str) -> dict:
    """One kernel's summary over ``rows`` (one dtype, so one route): sums of
    times and bounds, the bound's share of the time. ``route`` is the build
    route (CUDA C++), ``kernel_route`` the rows' kernel route."""
    bytes_ms = sum(r["bytes_ms"] for r in rows)
    ops_ms = sum(r["ops_ms"] for r in rows)
    ms = sum(r["ms"] for r in rows)
    bound_ms = sum(max(r["bytes_ms"], r["ops_ms"]) for r in rows)
    return {"name": kernel, "route": "cuda",
            "kernel_route": rows[0]["route"], "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": ms, "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_share": bound_ms / ms, "library_ms": None}


VGI_AGREE_MIN = 0.999  # device VGI and the ground fit, card vs CPU
LIDAR_POINTS = 120000   # one raw SemanticKITTI scan


def lidar_scan(seed: int, n: int = LIDAR_POINTS):
    """(N, 3) float32 points of a 360-degree, 64-beam LiDAR-like scan: beams
    from -24.9 to +2 degrees; a beam hits the road 1.73 m below the sensor
    (out to 80 m), a box or wall in front of it (a third of the returns),
    or, above the horizon, a wall up to 60 m away; a few reflections
    below the road."""
    import numpy as np

    rng = np.random.default_rng(seed)
    beams = 64
    per = n // beams
    elev = np.deg2rad(np.linspace(-24.9, 2.0, beams))[:, None]
    az = rng.uniform(-np.pi, np.pi, (beams, per))
    down = np.tan(-np.clip(elev, None, -1e-3))
    r = np.where(elev < -0.01, 1.73 / down, rng.uniform(10, 60, (beams, per)))
    r = np.clip(r, 0, 80.0)
    hit = rng.random((beams, per)) < 0.33
    r = np.where(hit, r * rng.uniform(0.2, 0.9, (beams, per)), r)
    r = r * (1 + rng.normal(0, 0.002, (beams, per)))
    z = r * np.tan(elev)
    z = np.where(~hit & (elev < -0.01), -1.73 + rng.normal(0, 0.02, z.shape),
                 z)
    refl = rng.random((beams, per)) < 0.005
    z = np.where(refl, z - rng.uniform(1.5, 3.0, z.shape), z)
    pts = np.stack([r * np.cos(az), r * np.sin(az), z], -1).reshape(-1, 3)
    return pts.astype(np.float32)


_RUNTIME_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync",
                  "cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize")


def runtime_calls(fn) -> dict:
    """Counts of the CUDA runtime calls in one traced call of ``fn``:
    kernel launches, copies, and the synchronizes that make the host wait
    for the card (the trace's own closing ``cudaDeviceSynchronize`` is not
    counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(_RUNTIME_CALLS, 0)
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in counts:
            counts[ev.name()] += 1
    counts["cudaDeviceSynchronize"] -= 1
    return counts


def agreement(a, b) -> tuple:
    """(share of equal rows, number of differing rows) of two tensors
    compared along their first dimension (all other dims must match)."""
    eq = (a.cpu() == b.cpu()).reshape(a.shape[0], -1).all(1)
    return float(eq.float().mean()), int((~eq).sum())


def vgi_device_batches(n: int, start: int, with_ema: bool, cfg) -> list:
    """``n`` (source, target) pairs like :func:`mopa_batches`' before the
    loader's host VGI: the targets keep their raw VGI inputs and the scans
    carry their host-built plans."""
    from mopa_tpu_torch.data import synthetic

    host = dict(synthetic.host_plan_settings(cfg, POINT_BUDGET, seed=start),
                vgi=None)
    pairs = train_batches(n, TRAIN_BATCH, start, with_ema, with_vgi=True)
    for src, trg in pairs:
        synthetic.add_host_plans(src, host)
        synthetic.add_host_plans(trg, host)
        if "hp_cat_rankn" in trg or "ori_points" not in trg:
            fail("device-VGI batch carries a host cat plan or no raw inputs")
    return pairs


def vgi_insert_check(cfg, pairs, host_report, device) -> dict:
    """(a): device VGI on the card vs the CPU on the same draws, and its
    time per batch beside host VGI's."""
    import torch

    from mopa_tpu_torch.ops import mixmatch
    from mopa_tpu_torch.train import trainer
    from mopa_tpu_torch.train.common import decode_batch

    out = {"agreement": [], "differing_points": []}
    gen = torch.Generator(device=device).manual_seed(5)
    for i, (_, trg) in enumerate(pairs):
        dev = decode_batch(trg, device)
        obj_valid = dev["obj_valid"]
        draws = mixmatch.vgi_draws(obj_valid.shape[0], obj_valid.shape[1],
                                   mixmatch.search_grid(cfg.TRAIN.PC_MM), gen,
                                   device)
        got = mixmatch.vgi_insert_batch(cfg, dev, True, draws)
        want = mixmatch.vgi_insert_batch(
            cfg, decode_batch(trg, "cpu"), True,
            {k: v.cpu() for k, v in draws.items()})
        shares, differ = {}, {}
        for k in ("coords", "valid", "label", "obj_mask", "inserted"):
            shares[k], differ[k] = agreement(got[k], want[k])
        out["agreement"].append(shares)
        out["differing_points"].append(differ)
        print("device VGI batch {}: agreement with the CPU {}, differing "
              "points {}, inserted {} of {} objects".format(
                  i, shares, differ, int(got["inserted"].sum()),
                  got["inserted"].numel()), flush=True)
        if min(shares.values()) < VGI_AGREE_MIN:
            fail("device VGI on the card disagrees with the CPU: {}".format(
                shares))
        if not bool(got["inserted"].any()):
            fail("device VGI inserted no object in batch {}".format(i))
    dev = decode_batch(pairs[0][1], device)
    times = [timed_call(mixmatch.vgi_insert, cfg, dev, True, gen)[1]
             for _ in range(WARM_REQUESTS + 1)][1:]
    out["insert_ms"] = times
    out["insert_median_ms"] = statistics.median(times)
    out["runtime_calls"] = {
        "insert": runtime_calls(
            lambda: mixmatch.vgi_insert(cfg, dev, True, gen)),
        "insert_and_cat_plan": runtime_calls(
            lambda: trainer.device_vgi(cfg, dev, True, gen))}
    print("runtime calls of one device VGI insert, and of the insert with "
          "the cat plan build (train/vgi): {}".format(out["runtime_calls"]),
          flush=True)
    out["host_vgi_ms"] = [r["vgi_ms"] for r in host_report["per_pair_ms"]]
    print("device VGI insert, {} scans of {} + {} points (ms): {}; median "
          "{:.2f}; host VGI per batch in phase 7 (ms): {}".format(
              TRAIN_BATCH, POINT_BUDGET, dev["obj_valid"].shape[-1], times,
              out["insert_median_ms"], out["host_vgi_ms"]), flush=True)
    return out


def ground_check(device) -> dict:
    """(b): the ground fit on one 120,000-point scan, card vs CPU."""
    import torch

    from mopa_tpu_torch.ops import ground

    pts = torch.from_numpy(lidar_scan(11))
    valid = torch.ones(pts.shape[0], dtype=torch.bool)
    want = ground.estimate_ground(pts, valid)
    pts_d, valid_d = pts.to(device), valid.to(device)
    got = ground.estimate_ground(pts_d, valid_d)
    share, differ = agreement(got, want)
    times = [timed_call(ground.estimate_ground, pts_d, valid_d)[1]
             for _ in range(WARM_REQUESTS)]
    out = {"points": int(pts.shape[0]), "ground_share": float(want.float()
                                                              .mean()),
           "agreement": share, "differing_points": differ, "ms": times,
           "median_ms": statistics.median(times),
           "runtime_calls": runtime_calls(
               lambda: ground.estimate_ground(pts_d, valid_d))}
    print("ground fit, {} points: ground share {:.3f}, agreement with the "
          "CPU {:.6f} ({} points differ); ms {}; runtime calls {}".format(
              out["points"], out["ground_share"], share, differ, times,
              out["runtime_calls"]), flush=True)
    if share < VGI_AGREE_MIN or not 0.05 < out["ground_share"] < 0.95:
        fail("ground fit on the card: {}".format(out))
    return out


def device_vgi_steps(cfg, dev_pairs, host_pairs, device,
                     with_ema: bool) -> dict:
    """(c): the shipped MoPA step through the device route (counted launches,
    finite losses, inserted points, the traced ``train/vgi`` stage), then
    host-VGI and device-VGI steps in turns."""
    import torch

    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.train import trainer

    tag = "device-VGI " + ("EMA" if with_ema else "pre-EMA")
    models = trainer.build_models(cfg, device=device, seed=0)
    state = trainer.create_train_state(cfg, models)
    step = trainer.make_train_step(cfg, models, with_pl=True,
                                   with_ema=with_ema)
    scc.reset_launch_counts()
    steps = []
    for i, (src, trg) in enumerate(dev_pairs):
        (state, metrics), ms, peak = timed_call(step, state, src, trg)
        losses = _losses(metrics)
        if not all(torch.isfinite(torch.tensor(list(losses.values())))) \
                or not losses.get("vgi_inserted", 0) > 0:
            fail("{} step {}: {}".format(tag, i, losses))
        steps.append({"ms": ms, "peak_mib": peak, "losses": losses})
        print("{} step {}: {:.2f} ms, peak {:.0f} MiB, {}".format(
            tag, i, ms, peak, losses), flush=True)
    launches = dict(scc.launches)
    n, k = len(conv_shapes()), len(dev_pairs)
    want = {K1: (2 if with_ema else 1) * n * k, K2_DFEATS: (n - 1) * k,
            K2_DW: n * k, P1: 0, P2: 0}
    if launches != want:
        fail("{} path launched {}, expected {}".format(tag, launches, want))
    routes = tensor_core_routes(tag + " path")
    stages = (trainer.TEACHER_STAGES if with_ema else ()) \
        + trainer.TRAIN_STAGES
    src, trg = dev_pairs[0]
    prof = profile_call(lambda: step(state, src, trg), stages, top=16)
    vgi_stage = prof.get("stages", {}).get("train/vgi", {})
    print("{} traced step: wall {} ms, busy {} ms, idle {}; train/vgi "
          "stage {}".format(tag, prof.get("wall_ms"),
                            prof.get("device_busy_ms"),
                            prof.get("device_idle_share"), vgi_stage),
          flush=True)
    if not vgi_stage.get("device_kernel_ms", 0) > 0:
        fail("{}: the traced step ran no kernel in train/vgi".format(tag))
    turns = {"host_vgi_ms": [], "device_vgi_ms": []}
    hsrc, htrg = host_pairs[0]
    for order in ("host", "device", "device", "host") * 2:
        pair = (hsrc, htrg) if order == "host" else (src, trg)
        turns[order + "_vgi_ms"].append(timed_call(step, state, *pair)[1])
    turns["host_vgi_median_ms"] = statistics.median(turns["host_vgi_ms"])
    turns["device_vgi_median_ms"] = statistics.median(turns["device_vgi_ms"])
    print("{} step in turns with host VGI (ms): {}".format(tag, turns),
          flush=True)
    del models, state, step
    torch.cuda.empty_cache()
    return {"steps": steps, "launches": launches, "routes": routes,
            "profile": prof, "turns": turns}


def overflow_check(cfg, device) -> dict:
    """(d): host plans that overflow a patched fixup budget leave the raw
    VGI inputs; the step trains through the device route."""
    import torch

    from mopa_tpu_torch.data import native_loader, synthetic
    from mopa_tpu_torch.train import trainer

    host = synthetic.host_plan_settings(cfg, POINT_BUDGET, seed=700)
    src, trg = train_batches(1, TRAIN_BATCH, 700, with_vgi=True)[0]
    with mock.patch.object(native_loader, "FIXUP_BUDGET", 1):
        synthetic.add_host_plans(src, host)
        synthetic.add_host_plans(trg, host)
    if "hp_cat_rankn" in trg or "ori_points" not in trg:
        fail("the patched fixup budget did not overflow the cat plan")
    models = trainer.build_models(cfg, device=device, seed=0)
    state = trainer.create_train_state(cfg, models)
    step = trainer.make_train_step(cfg, models, with_pl=True)
    state, metrics = step(state, src, trg)
    losses = _losses(metrics)
    print("overflowing host plans (fixup budget 1): the step trained "
          "through device VGI: {}".format(losses), flush=True)
    if not all(torch.isfinite(torch.tensor(list(losses.values())))) \
            or not losses.get("vgi_inserted", 0) > 0:
        fail("overflow batch: {}".format(losses))
    del models, state, step
    torch.cuda.empty_cache()
    return {"losses": losses}


def device_vgi_phase(device, report: dict, host_pairs: dict) -> dict:
    """Phase 11: device VGI, (a)-(d) of the module docstring.
    ``host_pairs`` holds phases 7 and 8's host-VGI batches."""
    cfg = make_cfg("bfloat16", train=True, vgi=True)
    pre = vgi_device_batches(COUNTED_STEPS, 500, False, cfg)
    out = {"insert": vgi_insert_check(cfg, pre, report["mopa"]["host"],
                                      device),
           "ground": ground_check(device)}
    out["step"] = device_vgi_steps(cfg, pre, host_pairs["mopa"], device,
                                   False)
    ema = vgi_device_batches(COUNTED_STEPS, 600, True, cfg)
    out["step_ema"] = device_vgi_steps(
        make_cfg("bfloat16", train=True, ema_xm_prob=0.7, vgi=True), ema,
        host_pairs["mopa_ema"], device, True)
    out["overflow"] = overflow_check(cfg, device)
    return out


SAM_IMG = 1024          # segment-anything's input side
SAM_POINTS = 32         # points per side of the id map (1,024 prompts)
SAM_CHECK_POINTS = 8    # points per side of the card-vs-CPU id maps
SAM_MASK_BUDGET = 64    # TPU.SAM_MASK_BUDGET
SAM_IOU_THRESH = 0.7
SAM_TOL = 1e-3          # card vs CPU, of max|ref|
SAM_AGREE_MIN = 0.999   # card vs CPU id maps, share of equal pixels
SAM_TIMED = 5


def sam_encoder_flops(variant: str, img_size: int, window: int = 14) -> dict:
    """FLOPs (2 per multiply-add) of one ``SAM.encode`` as the port runs it:
    windowed blocks project their zero-padded windows; the attention's
    scores, relative-position bias and values; patch embedding and neck."""
    from mopa_tpu_torch.models.sam import PATCH, VARIANTS

    v = VARIANTS[variant]
    d, g = v["dim"], -(-img_size // PATCH)
    t = g * g
    out = {"patch_embed": 2 * t * d * 3 * PATCH * PATCH,
           "neck": 2 * t * 256 * (d + 9 * 256),
           "gemm": 0, "attention": 0}
    for i in range(v["depth"]):
        win = g if i in v["global_idx"] else window
        n_win = (-(-g // win)) ** 2
        tp, n = n_win * win * win, win * win
        out["gemm"] += 2 * tp * d * 4 * d + 2 * t * d * 8 * d
        out["attention"] += 2 * n_win * n * d * (2 * n + 2 * win)
    out["total"] = sum(out.values())
    return out


def sam_encode_check(device) -> tuple:
    """(a): ViT-H encode on one 1024 x 1024 image: warm times, peak memory,
    FLOPs and TFLOP/s, a traced call; two calls must agree bit for bit."""
    import torch

    from mopa_tpu_torch.models import sam as sam_mod
    from mopa_tpu_torch.tools.gather_micro import PEAK_FLOPS

    t0 = time.perf_counter()
    model = sam_mod.SAM("vit_h", SAM_IMG, device=device, seed=0).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(12)
    image = torch.randn(SAM_IMG, SAM_IMG, 3, generator=gen, device=device)
    with torch.no_grad():
        first, first_ms, _ = timed_call(model.encode, image[None])
        runs = [timed_call(model.encode, image[None])
                for _ in range(SAM_TIMED)]
        prof = profile_call(lambda: model.encode(image[None]), ())
    emb = runs[-1][0]
    if emb.shape != (1, SAM_IMG // 16, SAM_IMG // 16, 256) \
            or not bool(torch.isfinite(emb).all()):
        fail("ViT-H embeddings: shape {}, finite {}".format(
            tuple(emb.shape), bool(torch.isfinite(emb).all())))
    if not torch.equal(first, emb):
        fail("two ViT-H encodes differ: max |diff| {}".format(
            float((first - emb).abs().max())))
    ms = [r[1] for r in runs]
    flops = sam_encoder_flops("vit_h", SAM_IMG)
    median = statistics.median(ms)
    out = {"params": sum(p.numel() for p in model.parameters()),
           "build_s": build_s, "first_ms": first_ms, "ms": ms,
           "median_ms": median, "peak_mib": max(r[2] for r in runs),
           "flops": flops, "tflops_per_s": flops["total"] / median / 1e9,
           "f32_peak_share": flops["total"] / median / 1e-3
           / PEAK_FLOPS["float32"],
           "profile": prof}
    print("SAM ViT-H encode at {0}x{0} (f32, TF32 off): {1} parameters "
          "built in {2:.2f} s; first call {3:.2f} ms; warm ms {4}, median "
          "{5:.2f}; peak {6:.0f} MiB; {7:.4e} FLOP ({8}); {9:.2f} TFLOP/s, "
          "{10:.3f} of the f32 peak; traced wall {11} ms, busy {12} ms, "
          "idle {13}; top kernels {14}".format(
              SAM_IMG, out["params"], build_s, first_ms, ms, median,
              out["peak_mib"], flops["total"], flops, out["tflops_per_s"],
              out["f32_peak_share"], prof.get("wall_ms"),
              prof.get("device_busy_ms"), prof.get("device_idle_share"),
              prof.get("top_device_ms", [])[:6]), flush=True)
    return model, image, out


def sam_id_map_check(model, image, device) -> dict:
    """(b): ``generate_mask_id_map`` at 1024 with 32 x 32 prompts, timed and
    traced by its ``sam/*`` ranges; then once with no IoU cut. Each id map
    and a seeded probability map give a finite ``mask_cons_loss``; the map
    without the cut must hold a mask."""
    import torch

    from mopa_tpu_torch.models import losses
    from mopa_tpu_torch.models import sam as sam_mod

    gen = torch.Generator(device=device).manual_seed(13)
    probs = torch.softmax(torch.randn(1, SAM_IMG, SAM_IMG, NUM_CLASSES,
                                      generator=gen, device=device), -1)

    def run(iou_thresh=SAM_IOU_THRESH):
        return sam_mod.generate_mask_id_map(
            model, image, points_per_side=SAM_POINTS,
            mask_budget=SAM_MASK_BUDGET, iou_thresh=iou_thresh,
            img_size=SAM_IMG)

    def consumed(id_map) -> dict:
        ids = id_map.unique()
        if id_map.shape != (SAM_IMG, SAM_IMG) \
                or id_map.dtype != torch.int32 or not bool(
                    ((ids == -100) | ((ids >= 0) & (ids < SAM_MASK_BUDGET)))
                    .all()):
            fail("SAM id map: shape {}, dtype {}, ids {}".format(
                tuple(id_map.shape), id_map.dtype, ids.tolist()))
        loss = float(losses.mask_cons_loss(probs, id_map[None],
                                           SAM_MASK_BUDGET))
        if not math.isfinite(loss):
            fail("mask_cons_loss on the SAM id map: {}".format(loss))
        return {"masks_written": int((ids >= 0).sum()),
                "assigned_share": float((id_map >= 0).float().mean()),
                "mask_cons_loss": loss}

    id_map, first_ms, _ = timed_call(run)
    runs = [timed_call(run) for _ in range(3)]
    if not all(torch.equal(r[0], id_map) for r in runs):
        fail("SAM id maps differ between calls")
    prof = profile_call(run, sam_mod.STAGES)
    ms = [r[1] for r in runs]
    out = {"first_ms": first_ms, "ms": ms, "median_ms": statistics.median(ms),
           "peak_mib": max(r[2] for r in runs), **consumed(id_map),
           "no_cut": consumed(run(-1e9)),
           "stages": {k: prof.get("stages", {}).get(k) for k in
                      sam_mod.STAGES},
           "wall_ms": prof.get("wall_ms"),
           "device_busy_ms": prof.get("device_busy_ms"),
           "device_idle_share": prof.get("device_idle_share"),
           "top_device_ms": prof.get("top_device_ms")}
    if not out["no_cut"]["masks_written"]:
        fail("the SAM id map without an IoU cut holds no mask")
    by_range = {k: [(v or {}).get(f) for f in ("host_ms", "device_kernel_ms",
                                                "device_span_ms")]
                for k, v in out["stages"].items()}
    print("SAM id map ({0}x{0}, {1}x{1} prompts, budget {2}, iou > {3}): "
          "first {4:.2f} ms; warm ms {5}, median {6:.2f}; peak {7:.0f} MiB; "
          "{8} masks written, {9:.3f} of the pixels assigned, "
          "mask_cons_loss {10:.6f}; without the IoU cut {11}; traced wall "
          "{12} ms, busy {13} ms, idle {14}; by range (host ms, kernel ms, "
          "device span ms) {15}; top kernels {16}".format(
              SAM_IMG, SAM_POINTS, SAM_MASK_BUDGET, SAM_IOU_THRESH, first_ms,
              ms, out["median_ms"], out["peak_mib"], out["masks_written"],
              out["assigned_share"], out["mask_cons_loss"], out["no_cut"],
              out["wall_ms"], out["device_busy_ms"],
              out["device_idle_share"], by_range,
              (out["top_device_ms"] or [])[:6]), flush=True)
    return out


def sam_card_vs_cpu(device) -> dict:
    """(c): ViT-B at 1024 with the same weights and image on the card and
    the CPU: embeddings, decoded masks and IoU scores within
    ``SAM_TOL`` x max|ref|; id maps (8 x 8 prompts, no IoU cut) equal on
    ``SAM_AGREE_MIN`` of the pixels."""
    import torch

    from mopa_tpu_torch.models import sam as sam_mod

    cpu = sam_mod.SAM("vit_b", SAM_IMG, device="cpu", seed=1).eval()
    card = sam_mod.SAM("vit_b", SAM_IMG, device=device).eval()
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(14)
    image = torch.randn(SAM_IMG, SAM_IMG, 3, generator=gen)
    points = torch.rand(8, 2, 2, generator=gen) * SAM_IMG
    labels = torch.tensor([[1.0, 0.0], [1.0, 1.0]]).repeat(4, 1)
    out = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        emb_ref = cpu.encode(image[None])
        masks_ref, iou_ref = cpu.decode(emb_ref.expand(8, -1, -1, -1),
                                        points, labels)
        out["cpu_s"] = time.perf_counter() - t0
        emb = card.encode(image.to(device)[None])
        masks, iou = card.decode(emb.expand(8, -1, -1, -1),
                                 points.to(device), labels.to(device))
    for name, got, ref in (("embeddings", emb, emb_ref),
                           ("masks", masks, masks_ref), ("iou", iou, iou_ref)):
        err = float((got.cpu() - ref).abs().max())
        scale = float(ref.abs().max())
        out[name] = {"max_abs_err": err, "max_abs_ref": scale}
        if not err <= SAM_TOL * scale:
            fail("SAM ViT-B {} on the card vs the CPU: max |err| {} > {} x "
                 "{}".format(name, err, SAM_TOL, scale))
    kw = dict(points_per_side=SAM_CHECK_POINTS, mask_budget=SAM_MASK_BUDGET,
              iou_thresh=-1e9, img_size=SAM_IMG)
    ref = sam_mod.generate_mask_id_map(cpu, image, **kw)
    got = sam_mod.generate_mask_id_map(card, image, **kw).cpu()
    differ = int((got != ref).sum())
    out["id_map"] = {"agreement": 1.0 - differ / ref.numel(),
                     "differing_pixels": differ,
                     "masks_written": int((ref.unique() >= 0).sum())}
    print("SAM ViT-B card vs CPU at {}: {}".format(SAM_IMG, out), flush=True)
    if out["id_map"]["agreement"] < SAM_AGREE_MIN:
        fail("SAM ViT-B id maps on the card vs the CPU: {}".format(
            out["id_map"]))
    return out


def sam_phase(device) -> dict:
    """Phase 12: Segment-Anything, (a)-(d) of the module docstring."""
    import torch

    from mopa_tpu_torch.ops import sparse_conv_cuda as scc

    scc.reset_launch_counts()
    model, image, encode = sam_encode_check(device)
    out = {"encode": encode, "id_map": sam_id_map_check(model, image, device)}
    del model, image
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = sam_card_vs_cpu(device)
    out["launches"] = dict(scc.launches)
    if any(out["launches"].values()):
        fail("the SAM phase launched {}".format(out["launches"]))
    return out


# -- phase 13: the other 3D backbones and the depth head
RANGE_HW = (64, 1024)  # SemanticKITTISCN's proj_H x proj_W
SYNTH_POINTS = 24000   # points per raw synthetic scan (phase 9's size)
BACKBONE_VAL_SCANS = 4
# launches timed for each SPVCNN conv shape no wider than COUT_MAX (the
# shapes above it, which run as column blocks, take TIMED_LAUNCHES)
NARROW_TIMED_LAUNCHES = 5


def spvcnn_conv_shapes(cs=None, in_channels: int = 4) -> list:
    """(conv, plan level, Cin, Cout) of SPVCNN's submanifold convs at channel
    schedule ``cs`` (``DEFAULT_CS``), one for each distinct (level, Cin,
    Cout), named after the first conv of that shape: the stem, each encoder
    stage's residual blocks and each decoder stage's (the input of
    ``upres{t}a`` holds the skip concat). The blocks' 1x1 skips are plain
    matmuls, no K1 / K2."""
    from mopa_tpu_torch.models.spvcnn import DEFAULT_CS

    cs = DEFAULT_CS if cs is None else cs
    convs = [("stem1", 0, in_channels, cs[0]), ("stem2", 0, cs[0], cs[0])]
    for i in range(1, 5):
        convs += [("res{}a.conv1".format(i), i, cs[i - 1], cs[i]),
                  ("res{}a.conv2".format(i), i, cs[i], cs[i])]
    for t, (level, cout, skip_c) in enumerate(
            ((3, cs[5], cs[3]), (2, cs[6], cs[2]), (1, cs[7], cs[1]),
             (0, cs[8], cs[0])), start=1):
        convs += [("upres{}a.conv1".format(t), level, cout + skip_c, cout),
                  ("upres{}a.conv2".format(t), level, cout, cout)]
    seen, out = set(), []
    for conv in convs:
        if conv[1:] not in seen:
            seen.add(conv[1:])
            out.append(conv)
    return out


def backbone_cfg(backbone: str, dtype: str, batch_size: int = TRAIN_BATCH,
                 depth: bool = False):
    """The shipped model pair and schedule (:func:`make_cfg`) with
    ``MODEL_3D.TYPE`` ``backbone`` (SPVCNN's 4 input channels); with
    ``depth`` the MoPA step, VGI on, with ``TRAIN.DEPTH_PRED`` and
    ``lambda_dp_src`` 0.1 (no shipped YAML sets it: this phase's choice).
    The val stream is ``BACKBONE_VAL_SCANS`` synthetic scans."""
    c = make_cfg(dtype, train=True, batch_size=batch_size, vgi=depth)
    c.defrost()
    c.MODEL_3D.TYPE = backbone
    c.TRAIN.DEPTH_PRED = depth
    c.TRAIN.DEPTH_PRED_COE.lambda_dp_src = 0.1 if depth else 0.0
    c.DATASET_TARGET.TYPE = "SyntheticSCN"
    c.DATASET_TARGET.VAL = ("val",)
    t = c.DATASET_TARGET.SyntheticSCN
    t.length = BACKBONE_VAL_SCANS
    t.n_points = SYNTH_POINTS
    t.image_size = IMAGE_SIZE
    t.num_classes = NUM_CLASSES
    t.proj_H, t.proj_W = RANGE_HW
    c.VAL.BATCH_SIZE = 2
    c.freeze()
    return c


def backbone_batches(cfg, start: int, batch_size: int = TRAIN_BATCH) -> tuple:
    """(source, target) numpy batches of ``cfg``'s 3D inputs made as the
    train loader makes them: ``SyntheticSCN`` scans (KITTI geometry,
    ``SYNTH_POINTS`` points, the source with depth labels under
    ``TRAIN.DEPTH_PRED``, the target with pseudo labels) collated at the
    point budget, key-sorted, with host-built plans of the backbone's
    levels (none for SalsaNext)."""
    from mopa_tpu_torch.data.collate import collate_padded
    from mopa_tpu_torch.data.synthetic import SyntheticSCN
    from mopa_tpu_torch.models.build import plan_levels
    from mopa_tpu_torch.models.scn_unet import capacity_schedule

    levels = plan_levels(cfg)
    caps = None if levels is None else capacity_schedule(POINT_BUDGET,
                                                         levels)
    out = []
    for seed, kw in ((1, {"with_depth_label": bool(cfg.TRAIN.DEPTH_PRED)}),
                     (2, {"with_pseudo_labels": True})):
        ds = SyntheticSCN(length=start + batch_size, n_points=SYNTH_POINTS,
                          image_size=IMAGE_SIZE, num_classes=NUM_CLASSES,
                          backbone=cfg.MODEL_3D.TYPE, proj_H=RANGE_HW[0],
                          proj_W=RANGE_HW[1], seed=seed, **kw)
        out.append(collate_padded([ds[start + i] for i in range(batch_size)],
                                  POINT_BUDGET, sort_points=True,
                                  host_plan_capacities=caps))
    return tuple(out)


def no_dropout(models) -> None:
    """Dropout rates to 0 in both nets (the card's and the CPU's generators
    draw different masks)."""
    for mod in list(models.model_2d.modules()) + list(
            models.model_3d.modules()):
        for name in ("dropout", "dropout_rate"):
            if isinstance(getattr(mod, name, None), float):
                setattr(mod, name, 0.0)


def backbone_step(cfg, src, trg, device, tag: str, with_pl: bool = True,
                  with_mopa: bool = False) -> dict:
    """``cfg``'s train step at full width on the card: counted launches of
    one step by kernel and route, losses falling over ``REPEATED_STEPS``
    steps on the batch, the median of ``WARM_REQUESTS`` warm steps, peak
    memory and one traced step. Returns (report, models)."""
    import torch

    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.train import trainer

    models = trainer.build_models(cfg, device=device, seed=0)
    state = trainer.create_train_state(cfg, models)
    step = trainer.make_train_step(cfg, models, with_pl=with_pl,
                                   with_mopa=with_mopa)
    scc.reset_launch_counts()
    (state, metrics), first_ms, _ = timed_call(step, state, src, trg)
    out = {"first_ms": first_ms, "launches": dict(scc.launches),
           "routes": {k: dict(v) for k, v in scc.routes.items()},
           "losses": _losses(metrics)}
    totals = []
    for _ in range(REPEATED_STEPS):
        state, metrics = step(state, src, trg)
        losses = _losses(metrics)
        if not all(math.isfinite(x) for x in losses.values()):
            fail("{} step: non-finite loss {}".format(tag, losses))
        totals.append(losses["total_loss"])
    out["repeated_batch_total_loss"] = totals
    if not totals[-1] < totals[0]:
        fail("{} total_loss did not fall on a repeated batch: {}".format(
            tag, totals))
    out["last_losses"] = losses
    warm = [timed_call(step, state, src, trg) for _ in range(WARM_REQUESTS)]
    out["warm_steps_ms"] = [w[1] for w in warm]
    out["warm_step_median_ms"] = statistics.median(out["warm_steps_ms"])
    out["peak_mib"] = max(w[2] for w in warm)
    prof = profile_call(lambda: step(state, src, trg), trainer.TRAIN_STAGES)
    out["profile"] = prof
    print("{}: first step {:.2f} ms; launches {}; by route {}; total_loss "
          "over {} steps on one batch {}; warm ms {}, median {:.2f}; peak "
          "{:.0f} MiB; traced wall {} ms, busy {} ms, idle {}; stages "
          "(host ms, kernel ms) {}".format(
              tag, first_ms, out["launches"], out["routes"], REPEATED_STEPS,
              totals, out["warm_steps_ms"], out["warm_step_median_ms"],
              out["peak_mib"], prof.get("wall_ms"),
              prof.get("device_busy_ms"), prof.get("device_idle_share"),
              {k: [round(v["host_ms"], 2), round(v["device_kernel_ms"], 2)]
               for k, v in prof.get("stages", {}).items()}), flush=True)
    return out, models


def spvcnn_card_vs_cpu(device) -> dict:
    """The float32 SPVCNN step of 1 + 1 scans on the card (K1 / K2 on the
    CUDA-core route) and in the port on the CPU (the plain twins), the same
    weights, dropout off: every loss within 1e-3 (relative)."""
    from mopa_tpu_torch.train import trainer

    cfg = backbone_cfg("SPVCNN", "float32", batch_size=1)
    src, trg = backbone_batches(cfg, 0, batch_size=1)
    losses = {}
    for dev in (device, "cpu"):
        models = trainer.build_models(cfg, device=dev, seed=0)
        no_dropout(models)
        state = trainer.create_train_state(cfg, models)
        step = trainer.make_train_step(cfg, models, with_pl=True,
                                       with_mopa=False)
        losses[str(dev)] = _losses(step(state, src, trg)[1])
    card, cpu = losses[str(device)], losses["cpu"]
    worst = max(abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-6) for k in cpu)
    print("SPVCNN f32 1 + 1 step, card vs CPU: {}; largest relative "
          "difference {:.3g}".format(losses, worst), flush=True)
    if set(card) != set(cpu) or not worst <= 1e-3:
        fail("SPVCNN f32 step, card vs CPU: {}".format(losses))
    return {"losses": losses, "max_rel_diff": worst}


def backbone_validate(cfg, models, tag: str) -> dict:
    """``validate()`` over the ``BACKBONE_VAL_SCANS`` val scans."""
    import logging

    from mopa_tpu_torch.common.metric_logger import MetricLogger
    from mopa_tpu_torch.data.build import build_dataloader
    from mopa_tpu_torch.data.utils.validate import validate

    t0 = time.perf_counter()
    evals = validate(cfg, models, build_dataloader(cfg, "val", "target"),
                     MetricLogger(), logging.getLogger("chip_smoke"))
    out = {"s": time.perf_counter() - t0,
           "points": {k: int(e.confusion_matrix.sum())
                      for k, e in evals.items()},
           "miou": {k: float(e.overall_iou) for k, e in evals.items()}}
    print("{} validate() on {} val scans: {}".format(
        tag, BACKBONE_VAL_SCANS, out), flush=True)
    if not all(n > 0 for n in out["points"].values()):
        fail("{} validate() scored no point: {}".format(tag, out))
    return out


def backbone_phase(device, report: dict, mopa_target) -> dict:
    """Phase 13: (a) K1 / K2 against their twins at every conv shape of
    SPVCNN, those wider than 192 channels among them, (b) the SPVCNN and (c) the SalsaNext xMUDA steps at full width,
    (d) the shipped MoPA step with ``TRAIN.DEPTH_PRED``, (e) ``validate()``
    and the ``train_xmuda`` CLI for both backbones."""
    import tempfile

    import torch

    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.train.common import decode_batch
    from mopa_tpu_torch.train import trainer

    out = {}
    cfg = backbone_cfg("SPVCNN", "bfloat16")
    src, trg = backbone_batches(cfg, 0)
    # (a) on the 5-level plan of the step's 8 + 8 scans
    plan = trainer.build_train_plan(cfg, decode_batch(src, device),
                                    decode_batch(trg, device), False)[0]
    out["spvcnn_rows_per_level"] = [lv.valid.shape[0] for lv in plan.levels]
    gen = torch.Generator(device=device).manual_seed(13)
    out["wide_rows"], out["conv_rows"] = [], []
    for name, level, cin, cout in spvcnn_conv_shapes():
        wide = max(cin, cout) > scc.COUT_MAX
        out["wide_rows" if wide else "conv_rows"] += shape_rows(
            "spvcnn16", name, plan.levels[level], cin, cout, True, gen,
            device, TIMED_LAUNCHES if wide else NARROW_TIMED_LAUNCHES)
    del plan
    # (b)
    out["spvcnn"], models = backbone_step(cfg, src, trg, device,
                                          "SPVCNN step bf16 8+8")
    routes = out["spvcnn"]["routes"]
    for name in (K1, K2_DFEATS, K2_DW):
        if not (routes[name]["cuda-tensorcore"] > 0 and routes[name]["cuda"]
                > 0):
            fail("the SPVCNN step ran {} on routes {}: the bf16 encoder "
                 "and the f32 decoder each need theirs".format(name,
                                                               routes[name]))
    out["spvcnn"]["validate"] = backbone_validate(cfg, models, "SPVCNN")
    del models
    torch.cuda.empty_cache()
    out["spvcnn"]["card_vs_cpu"] = spvcnn_card_vs_cpu(device)
    # (c)
    cfg = backbone_cfg("SalsaNext", "bfloat16")
    src, trg = backbone_batches(cfg, 0)
    out["salsanext"], models = backbone_step(cfg, src, trg, device,
                                             "SalsaNext step bf16 8+8 at "
                                             "{}x{}".format(*RANGE_HW),
                                             with_pl=False)
    if any(out["salsanext"]["launches"].values()):
        fail("the SalsaNext step launched {}".format(
            out["salsanext"]["launches"]))
    out["salsanext"]["validate"] = backbone_validate(cfg, models,
                                                     "SalsaNext")
    del models
    torch.cuda.empty_cache()
    # (d) the source with depth labels, phase 7's MoPA target batch
    cfg = backbone_cfg("SCN", "bfloat16", depth=True)
    src, _ = backbone_batches(cfg, 0)
    out["depth"], models = backbone_step(cfg, src, mopa_target, device,
                                         "MoPA step with the depth head",
                                         with_mopa=True)
    del models
    torch.cuda.empty_cache()
    if not math.isfinite(out["depth"]["losses"].get("depth_pred_loss",
                                                    math.nan)):
        fail("no finite depth_pred_loss: {}".format(out["depth"]["losses"]))
    out["depth"]["phase7_step_median_ms"] = \
        report["mopa"]["warm_step_median_ms"]
    print("MoPA step with the depth head: median {:.2f} ms beside phase "
          "7's {:.2f} ms".format(out["depth"]["warm_step_median_ms"],
                                 out["depth"]["phase7_step_median_ms"]),
          flush=True)
    # (e) the CLI, mopa_smoke.yaml's size, each backbone
    out["cli"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backbone in ("SPVCNN", "SalsaNext"):
            cli_out = os.path.join(tmp, backbone)
            run = run_cli("mopa_tpu_torch.train.train_xmuda",
                          ["--cfg", SMOKE_YAML, "OUTPUT_DIR", cli_out,
                           "MODEL_3D.TYPE", backbone], cli_out,
                          log_name="train_xmuda_" + backbone)
            cli_models_dir(cli_out)
            out["cli"][backbone] = {"wall_s": run["wall_s"]}
    print("train_xmuda CLI: {}".format(out["cli"]), flush=True)
    return out


# -- phase 15: data parallelism (M13) and the other plan forms

DP_WORKER = "--dp-worker"
DP_WORLD = 2
DP_TIMEOUT_S = 420   # both workers, from their start
DP_SCANS = 4         # scans per rank and stream in (b): 8 + 8 in all
DP_PRE_STEPS, DP_EMA_STEPS = 3, 1
DP_TIMED_STEPS = 2
DP_TRAIN_ITERS = 4
W1_TURNS = 3         # (a): steps with and without the mesh, in turns
PLAN_FORM_TOL = 1e-3     # (c): logits, of max|ref|
PLAN_FORM_AGREE = 0.999  # (c): argmax agreement


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def state_tensors(state) -> list:
    """(name, tensor) of everything a train state carries: parameters,
    batch-norm buffers and EMA parameters, each optimizer's moments and
    steps, and the generator's state; ``step`` as a tensor."""
    import torch

    out = []
    for name in _STATE_DICTS:
        out += [(name + "." + k, v) for k, v in getattr(state, name).items()]
    for net in ("2d", "3d"):
        opt = getattr(state, "opt_" + net).optimizer
        for k, p in getattr(state, "params_" + net).items():
            for key, v in sorted(opt.state.get(p, {}).items()):
                out.append(("opt_{}.{}.{}".format(net, k, key), v))
    out.append(("rng", state.rng.get_state()))
    out.append(("step", torch.tensor([state.step])))
    return out


def state_digest(state) -> tuple:
    """(names, (n, 2) int64 CPU tensor): per tensor of
    :func:`state_tensors` the sum of its 32-bit words (bytes for 1- and
    2-byte tensors) and their position-weighted sum; equal digests of
    replicas that stepped alike show equal bits."""
    import torch

    names, rows, dev = [], [], state.params_2d[next(iter(state.params_2d))]
    for name, t in state_tensors(state):
        t = t.detach().contiguous().reshape(-1)
        w = (t.view(torch.int32) if t.element_size() in (4, 8)
             else t.view(torch.uint8)).long()
        pos = torch.arange(1, w.numel() + 1, device=w.device)
        rows.append(torch.stack([w.sum(), (w * pos).sum()]).to(dev.device))
        names.append(name)
    return names, torch.stack(rows).cpu()


def replicas_equal(state, mesh, tag: str) -> int:
    """Fails unless every rank's :func:`state_digest` equals rank 0's
    (``all_gather`` of the digests); returns the tensors compared."""
    import torch
    import torch.distributed as dist

    names, digest = state_digest(state)
    gathered = [torch.zeros_like(digest) for _ in range(mesh.size)]
    dist.all_gather(gathered, digest, group=mesh.group)
    for r, other in enumerate(gathered[1:], 1):
        bad = [n for n, a, b in zip(names, gathered[0], other)
               if not torch.equal(a, b)]
        if bad:
            fail("{}: rank {} differs from rank 0 in {} tensors, first {}"
                 .format(tag, r, len(bad), bad[:5]))
    return len(names)


def metrics_equal(a: dict, b: dict, tag: str) -> None:
    import torch

    if set(a) != set(b) or any(not torch.equal(a[k].cpu(), b[k].cpu())
                               for k in a):
        fail("{}: metrics differ: {} / {}".format(tag, _losses(a),
                                                  _losses(b)))


def deterministic(on: bool) -> None:
    """cuDNN's and PyTorch's deterministic algorithms on or off: the
    step's convolution and index backwards otherwise sum in an order that
    may change from run to run."""
    import torch
    import torch.utils.deterministic

    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def world1_check(device, batches_m, batches_me) -> dict:
    """Phase 15 (a): a one-rank NCCL mesh against ``mesh=None`` on the
    shipped MoPA step (bf16, 8 + 8 + 8 cat scans, SAM and VGI on), 3
    pre-EMA then 2 EMA steps from one seed on the same batches, with
    deterministic algorithms: metrics and states bit-equal. Then the step
    with and without the mesh in turns."""
    import torch
    import torch.distributed as dist

    from mopa_tpu_torch.parallel import mesh as mesh_mod
    from mopa_tpu_torch.train import trainer

    cfg_m = make_cfg("bfloat16", train=True, vgi=True)
    cfg_me = make_cfg("bfloat16", train=True, ema_xm_prob=0.7, vgi=True)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:{}".format(
        free_port()), rank=0, world_size=1)
    out = {}
    try:
        mesh = mesh_mod.data_mesh()
        runs = []
        for m in (None, mesh):
            models = trainer.build_models(cfg_m, device=device, seed=0)
            state = trainer.create_train_state(cfg_m, models)
            steps = (trainer.make_train_step(cfg_m, models, with_pl=True,
                                             mesh=m),
                     trainer.make_train_step(cfg_me, models, with_pl=True,
                                             with_ema=True, mesh=m))
            runs.append({"state": state, "steps": steps, "metrics": []})
        deterministic(True)
        try:
            for run in runs:
                for ema, pairs in ((0, batches_m), (1, batches_me)):
                    for src, trg in pairs:
                        run["state"], metrics = run["steps"][ema](
                            run["state"], src, trg)
                        run["metrics"].append(metrics)
                torch.cuda.synchronize()
        finally:
            deterministic(False)
        for i, (a, b) in enumerate(zip(*(r["metrics"] for r in runs))):
            metrics_equal(a, b, "world-1 mesh step {}".format(i))
        names_a, dig_a = state_digest(runs[0]["state"])
        names_b, dig_b = state_digest(runs[1]["state"])
        bad = [n for n, x, y in zip(names_a, dig_a, dig_b)
               if not torch.equal(x, y)]
        if names_a != names_b or bad:
            fail("world-1 mesh: the state differs from mesh=None's in {} "
                 "tensors, first {}".format(len(bad), bad[:5]))
        n_steps = len(batches_m) + len(batches_me)
        out["steps_bit_equal"] = n_steps
        out["tensors_bit_equal"] = len(names_a)
        out["collectives_per_step"] = mesh.collectives / n_steps
        out["bytes_per_step"] = mesh.bytes / n_steps
        # warm steps in turns: mesh=None, mesh, ...
        src, trg = batches_m[0]
        ms = {"none": [], "mesh": []}
        for _ in range(W1_TURNS):
            for key, run in zip(("none", "mesh"), runs):
                (run["state"], _), t, _ = timed_call(run["steps"][0],
                                                     run["state"], src, trg)
                ms[key].append(t)
        out["step_ms"] = ms
        out["step_median_ms"] = {k: statistics.median(v)
                                 for k, v in ms.items()}
    finally:
        dist.destroy_process_group()
    print("phase 15 (a) world-1 NCCL mesh: {} steps and {} tensors "
          "bit-equal to mesh=None; {} collectives, {:.2f} MB a step; step "
          "ms without / with the mesh {}".format(
              out["steps_bit_equal"], out["tensors_bit_equal"],
              out["collectives_per_step"], out["bytes_per_step"] / 1e6,
              out["step_median_ms"]), flush=True)
    return out


def dp_cfg(out_dir: str):
    """(b)'s ``train()`` config: ``mopa_smoke.yaml`` at its own size over
    two ranks: the EMA phase from iteration 2, checkpoints and validation
    at 4 (the file's own periods)."""
    from mopa_tpu_torch.config.xmuda import cfg

    c = cfg.clone()
    c.merge_from_file(str(ROOT / SMOKE_YAML))
    c.TPU.DATA_PARALLEL = DP_WORLD
    c.SCHEDULER.MAX_ITERATION = DP_TRAIN_ITERS
    c.OUTPUT_DIR = out_dir
    c.RNG_SEED = 0
    c.freeze()
    return c


def dp_steps(mesh, device) -> dict:
    """(b) in one rank: the shipped MoPA step at :data:`DP_SCANS` +
    :data:`DP_SCANS` scans, 3 pre-EMA steps and 1 EMA step, each with
    phase 7's (8's) launches, finite losses and the replicas bit-equal
    after it; then timed steps and their all-reduce."""
    import torch

    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.parallel import mesh as mesh_mod
    from mopa_tpu_torch.train import trainer

    cfg_m = make_cfg("bfloat16", train=True, vgi=True)
    cfg_me = make_cfg("bfloat16", train=True, ema_xm_prob=0.7, vgi=True)
    start = 1000 + 100 * mesh.rank  # each rank its own scans
    pre, _ = mopa_batches(DP_PRE_STEPS, start, False, cfg_m,
                          batch_size=DP_SCANS)
    ema, _ = mopa_batches(DP_EMA_STEPS, start + 50, True, cfg_m,
                          batch_size=DP_SCANS)
    models = trainer.build_models(cfg_m, device=device, seed=0)
    state = trainer.create_train_state(cfg_m, models)
    steps = (trainer.make_train_step(cfg_m, models, with_pl=True, mesh=mesh),
             trainer.make_train_step(cfg_me, models, with_pl=True,
                                     with_ema=True, mesh=mesh))
    n = len(conv_shapes())
    out = {"steps": []}
    for i, (is_ema, (src, trg)) in enumerate(
            [(0, p) for p in pre] + [(1, p) for p in ema]):
        scc.reset_launch_counts()
        (state, metrics), ms, peak = timed_call(steps[is_ema], state, src,
                                                trg)
        launches = dict(scc.launches)
        want = {K1: (2 if is_ema else 1) * n, K2_DFEATS: n - 1, K2_DW: n,
                P1: 0, P2: 0}
        if launches != want:
            fail("rank {} step {}: launched {}, expected {}".format(
                mesh.rank, i, launches, want))
        tensor_core_routes("rank {} step {}".format(mesh.rank, i))
        losses = _losses(metrics)
        if not all(math.isfinite(v) for v in losses.values()) or not (
                "pc_mm_loss" in losses and losses["vgi_inserted"] > 0):
            fail("rank {} step {}: losses {}".format(mesh.rank, i, losses))
        compared = replicas_equal(state, mesh, "after step {}".format(i))
        out["steps"].append({"ema": bool(is_ema), "ms": ms, "peak_mib": peak,
                             "losses": losses, "launches": launches,
                             "tensors_compared": compared})
    # timed: whole steps, then steps with each collective synchronised
    src, trg = pre[0]
    out["step_ms"] = [timed_call(steps[0], state, src, trg)[1]
                      for _ in range(DP_TIMED_STEPS)]
    reduce_ms, real = [], mesh_mod.all_reduce

    def timed_reduce(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(*args, **kwargs)
        torch.cuda.synchronize()
        reduce_ms[-1] += (time.perf_counter() - t0) * 1e3

    with mock.patch.object(mesh_mod, "all_reduce", timed_reduce):
        for _ in range(DP_TIMED_STEPS):
            reduce_ms.append(0.0)
            b0, c0 = mesh.bytes, mesh.collectives
            state, _ = steps[0](state, src, trg)
    out["allreduce_ms"] = reduce_ms
    out["allreduce_mb_per_step"] = (mesh.bytes - b0) / 1e6
    out["collectives_per_step"] = mesh.collectives - c0
    replicas_equal(state, mesh, "after the timed steps")
    return out


def dp_f32_card_vs_cpu(mesh, device) -> dict:
    """(b) in one rank: one float32 step of 1 + 1 scans (+ 1 cat) a rank
    over the mesh, on the card and on the CPU. Losses (reduced) to 1e-3
    relative; this rank's own gradients, as they enter the all-reduce, to
    1e-3 of each tensor's largest (phase 5's rule); the averaged gradients
    to 1e-3 of the largest of the ranks' own (the bound the mean of two
    such errors keeps: where the ranks' gradients cancel, the mean is
    smaller than either). Every rank takes phase 7's float32 batch, which
    that rule was set on: on another batch (start 401) a few 2D gradient
    tensors of one process differ card vs CPU by up to ~4e-3 of their
    largest, float32 rounding of the two backends (``PERF.md``, PR 13)."""
    import torch
    import torch.distributed as dist

    from mopa_tpu_torch.parallel import mesh as mesh_mod
    from mopa_tpu_torch.train import trainer

    cfg = make_cfg("float32", train=True, batch_size=1, vgi=True)
    (src, trg), = mopa_batches(1, 400, False, cfg, batch_size=1)[0]

    def run(dev):
        models = trainer.build_models(cfg, device=dev, seed=0)
        models.model_2d.net_2d.dropout_rate = 0.0
        lift_bn_biases(models[:2])
        state = trainer.create_train_state(cfg, models)
        step = trainer.make_train_step(cfg, models, with_pl=True, mesh=mesh)
        buckets, real = [], mesh_mod.all_reduce

        def recorded(m, tensors, average):
            # copies: on the CPU .float().cpu() would alias the gradients
            # that the all-reduce then averages in place
            buckets.append([t.detach().float().cpu().clone()
                            for t in tensors])
            real(m, tensors, average)

        with mock.patch.object(mesh_mod, "all_reduce", recorded):
            _, metrics = step(state, src, trg)
        local, mean = {}, {}
        for b, (net, params) in enumerate((("2d", state.params_2d),
                                           ("3d", state.params_3d))):
            names = [k for k, prm in params.items() if prm.grad is not None]
            if len(names) != len(params):
                fail("rank {} f32 step: a parameter of the {} net has no "
                     "gradient".format(mesh.rank, net))
            for k, g in zip(names, buckets[b]):
                local[net + ":" + k] = g
                mean[net + ":" + k] = params[k].grad.detach().float().cpu()
        return _losses(metrics), local, mean

    card_l, card_local, card_mean = run(device)
    cpu_l, cpu_local, cpu_mean = run("cpu")
    loss_rel = {k: abs(card_l[k] - cpu_l[k]) / max(abs(cpu_l[k]), 1e-12)
                for k in cpu_l}
    if set(card_l) != set(cpu_l) or max(loss_rel.values()) > 1e-3:
        fail("rank {} f32 step card vs CPU: losses {}".format(mesh.rank,
                                                              loss_rel))
    names = list(cpu_local)
    scale = torch.tensor([float(cpu_local[k].abs().max()) for k in names],
                         dtype=torch.float64)
    ranks_scale = scale.clone()
    dist.all_reduce(ranks_scale, op=dist.ReduceOp.MAX, group=mesh.group)
    top = {net: max(float(s) for k, s in zip(names, scale)
                    if k.startswith(net)) for net in ("2d", "3d")}
    worst = {"local": 0.0, "mean": 0.0}
    for i, k in enumerate(names):
        for kind, card, cpu, bound in (
                ("local", card_local, cpu_local, float(scale[i])),
                ("mean", card_mean, cpu_mean, float(ranks_scale[i]))):
            err = float((card[k] - cpu[k]).abs().max())
            if k.endswith((".conv.bias", ".tconv.bias")):
                # feeds a batch norm: the exact gradient is 0
                if max(err, bound) > 1e-3 * top[k.split(":")[0]]:
                    fail("rank {} f32 step: {} {} not ~0: {}".format(
                        mesh.rank, kind, k, err))
                continue
            if err > 1e-3 * bound:
                fail("rank {} f32 step card vs CPU: {} gradient {} differs "
                     "by {} (bound of 1e-3 x {})".format(
                         mesh.rank, kind, k, err, bound))
            worst[kind] = max(worst[kind], err / max(bound, 1e-30))
    return {"max_loss_rel": max(loss_rel.values()),
            "max_grad_rel_local": worst["local"],
            "max_grad_rel_mean": worst["mean"]}


def dp_train(mesh, device, out_dir: str) -> dict:
    """(b) in one rank: ``train()`` for :data:`DP_TRAIN_ITERS` iterations
    across the EMA switch on ``mopa_smoke.yaml`` over the mesh; rank 0
    alone saves; both ranks load the last checkpoints into fresh nets bit
    for bit; rank 0's validation equals one process's ``validate()`` on
    those weights."""
    import logging

    import torch

    from mopa_tpu_torch.common import checkpoint
    from mopa_tpu_torch.common.metric_logger import MetricLogger
    from mopa_tpu_torch.data.build import build_dataloader
    from mopa_tpu_torch.data.utils.validate import validate
    from mopa_tpu_torch.train import common, trainer

    cfg = dp_cfg(out_dir)
    log = logging.getLogger("chip_smoke.dp")
    log.setLevel(logging.WARNING)
    saves, real_save = [], checkpoint.CheckpointerV2.save

    def save(ck, name, *a, **kw):
        saves.append(name)
        return real_save(ck, name, *a, **kw)

    t0 = time.perf_counter()
    with mock.patch.object(checkpoint.CheckpointerV2, "save", save):
        state, eval_dict = common.train(cfg, log, out_dir, "run", "mopa")
    torch.cuda.synchronize()
    out = {"train_s": time.perf_counter() - t0, "saves": saves}
    if mesh.rank != 0 and (saves or eval_dict):
        fail("rank {} saved {} and validated {}".format(mesh.rank, saves,
                                                        list(eval_dict)))
    if mesh.rank == 0 and not {"model_2d_{:06d}".format(DP_TRAIN_ITERS),
                               "model_3d_{:06d}".format(DP_TRAIN_ITERS)
                               } <= set(saves):
        fail("rank 0 saved {}".format(saves))
    out["tensors_compared"] = replicas_equal(state, mesh, "after train()")
    # the resume: a fresh copy of the nets loads the last checkpoints
    models = trainer.build_models(cfg, device=device, seed=1)
    loaded = trainer.create_train_state(cfg, models)
    for which in ("2d", "3d"):
        ckpt = checkpoint.Checkpointer()._load_file(os.path.join(
            out_dir, "model_{}_{:06d}.pth".format(which, DP_TRAIN_ITERS)))
        trainer.CheckpointAdapter(which, models, loaded).load_state_dict(ckpt)
    out["resume_tensors_equal"] = states_equal(state, loaded)
    if mesh.rank == 0:
        one = validate(cfg, models, build_dataloader(cfg, "val", "target"),
                       MetricLogger(), log)
        for k, ev in eval_dict.items():
            if not (ev.confusion_matrix == one[k].confusion_matrix).all():
                fail("train()'s validation {} differs from one process's"
                     .format(k))
        out["val_miou"] = {k: float(ev.overall_iou)
                           for k, ev in eval_dict.items()}
    return out


def dp_worker(out_path: str) -> None:
    """Phase 15 (b) in one of :data:`DP_WORLD` processes (``python3
    chip_smoke.py --dp-worker <json>``, torchrun's variables in its
    environment): a gloo group, both ranks on the one card."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from mopa_tpu_torch.data import native_loader
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.parallel import mesh as mesh_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one core each: phase 14's host-bound worker runs beside this phase
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    scc.build()
    native_loader.build()
    job = json.loads(Path(out_path).read_text())
    # NCCL takes one rank per card: two ranks on the one card go over gloo,
    # which carries the CUDA tensors through the host
    dist.init_process_group("gloo", init_method="env://")
    mesh = mesh_mod.make_data_mesh(num_devices=DP_WORLD)
    try:
        out = {"rank": mesh.rank, "backend": mesh.backend}
        out["steps"] = dp_steps(mesh, device)
        torch.cuda.empty_cache()
        out["f32_card_vs_cpu"] = dp_f32_card_vs_cpu(mesh, device)
        out["train"] = dp_train(mesh, device, job["train_dir"])
        Path(out_path).write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def two_ranks_check() -> dict:
    """Phase 15 (b): :func:`dp_worker` in :data:`DP_WORLD` processes on the
    one card; their logs go to ``chiprun_out/dp_rank<r>.log``."""
    import tempfile

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    port = free_port()
    procs, files = [], []
    with tempfile.TemporaryDirectory() as train_dir:
        for r in range(DP_WORLD):
            job = out_dir / "dp_rank{}.json".format(r)
            job.write_text(json.dumps({"train_dir": train_dir}))
            log = open(out_dir / "dp_rank{}.log".format(r), "w")
            files.append(log)
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), WORLD_SIZE=str(DP_WORLD),
                       RANK=str(r), LOCAL_RANK="0")
            proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), DP_WORKER,
                 str(job)], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT)
            atexit.register(lambda p=proc: p.poll() is None and p.kill())
            procs.append(proc)
        t0 = time.perf_counter()
        rcs = []
        for proc in procs:
            try:
                rcs.append(proc.wait(timeout=max(
                    1.0, DP_TIMEOUT_S - (time.perf_counter() - t0))))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in files:
            f.close()
        wall = time.perf_counter() - t0
    ranks = []
    for r, rc in enumerate(rcs):
        text = (out_dir / "dp_rank{}.log".format(r)).read_text()
        print("-- rank {} log (last lines):\n{}".format(
            r, "\n".join(text.strip().splitlines()[-12:])), flush=True)
        if rc != 0:
            fail("phase 15 (b) rank {} ended with {}".format(
                r, "a timeout" if rc is None else "exit code {}".format(rc)))
        ranks.append(json.loads((out_dir / "dp_rank{}.json".format(r))
                                .read_text()))
    out = {"wall_s": wall, "ranks": ranks}
    for rank in ranks:
        print("phase 15 (b) rank {} over {}: step ms {}, all-reduce ms {} "
              "({:.2f} MB, {} collectives a step), f32 card vs CPU {}, "
              "train() {:.1f} s, saves {}".format(
                  rank["rank"], rank["backend"],
                  [s["ms"] for s in rank["steps"]["steps"]] + ["warm"]
                  + rank["steps"]["step_ms"], rank["steps"]["allreduce_ms"],
                  rank["steps"]["allreduce_mb_per_step"],
                  rank["steps"]["collectives_per_step"],
                  rank["f32_card_vs_cpu"], rank["train"]["train_s"],
                  rank["train"]["saves"]), flush=True)
    return out


def zdense_plan(plan, coords, batch_idx, valid):
    """``plan`` (the monolithic one of these points) with z-dense levels,
    built from its level tables as the JAX package's tests build them:
    ``build_zplan`` at level 0, ``zplan_from_nbr`` over a 5 V padded table
    above."""
    from mopa_tpu_torch.ops import sparse_conv as sc
    from mopa_tpu_torch.ops import voxel as voxel_ops

    caps = [lv.valid.shape[0] for lv in plan.levels]
    table = voxel_ops.voxelize(coords[None], valid[None], caps[0],
                               batch=batch_idx[None])[0]
    levels = []
    for l, lv in enumerate(plan.levels):
        if l == 0:
            z = sc.build_zplan(table)
        else:
            z = sc.zplan_from_nbr(lv.nbr, voxel_ops.build_padded_ztable(
                table, 5 * caps[l]))
        levels.append(lv._replace(nbr=None, ranks=z.ranks, p2a=z.p2a))
        if l + 1 < len(caps):
            table = voxel_ops.downsample_coords(table, caps[l + 1])[0]
    return plan._replace(levels=tuple(levels))


def plan_forms_check(batch_8, device) -> dict:
    """Phase 15 (c): the 3D net's float32 eval forward over the shipped
    batched plan, the monolithic plan (``nbr`` levels) and z-dense levels
    of 8 scans of 16,384 points: per-point logits within 1e-3 x max|ref|
    of the batched plan's, argmax agreement >= 0.999, K1 launching 14
    times on the wide form and never on the others; each form's plan-build
    and forward ms."""
    import torch

    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.train import trainer
    from mopa_tpu_torch.train.common import decode_batch

    cfg = make_cfg("float32")
    model = trainer.build_models(cfg, device=device, seed=0).model_3d.eval()
    batch = decode_batch(batch_8, device)
    b, p = batch["img_indices"].shape[:2]
    coords, feats = batch["coords"], batch["feats"]
    valid = batch["point_valid"].reshape(-1)
    bidx = batch["batch_idx"]

    def wide():
        return trainer.build_plan_from_batch(cfg, coords, valid, p)

    def nbr():
        return trainer.build_plan_from_batch(cfg, coords, valid, None,
                                             batch_idx=bidx)

    out, logits = {}, {}
    for name, build in (("wide", wide), ("nbr", nbr), ("zdense", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = build() if build else zdense_plan(nbr(), coords, bidx, valid)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            model(feats, plan)  # warm
            scc.reset_launch_counts()
            (res, fwd_ms, peak) = timed_call(model, feats, plan)
        k1 = scc.launches[K1]
        want = len(conv_shapes()) if name == "wide" else 0
        if k1 != want:
            fail("plan form {}: K1 launched {} times, expected {}".format(
                name, k1, want))
        logits[name] = res["seg_logit"].float()[valid]
        out[name] = {"plan_ms": build_ms, "forward_ms": fwd_ms,
                     "peak_mib": peak, "k1_launches": k1,
                     "num_voxels": plan.num_voxels.tolist()}
        del plan
    ref = logits["wide"]
    top = float(ref.abs().max())
    for name in ("nbr", "zdense"):
        err = float((logits[name] - ref).abs().max())
        agree = float((logits[name].argmax(-1) == ref.argmax(-1))
                      .float().mean())
        out[name].update(max_abs_err=err, rel_err=err / top, argmax=agree)
        if err > PLAN_FORM_TOL * top or agree < PLAN_FORM_AGREE:
            fail("plan form {}: logits differ by {} (max|ref| {}), argmax "
                 "agreement {}".format(name, err, top, agree))
    print("phase 15 (c) plan forms, {} x {} points, f32 3D eval forward: "
          "{}".format(b, p, out), flush=True)
    return out


def dp_phase(device, batches_m, batches_me, batch_8) -> dict:
    """Phase 15: (a) a one-rank NCCL mesh against no mesh, bit for bit;
    (b) two ranks over gloo on the one card; (c) the plan forms."""
    import torch

    out = {"world1": world1_check(device, batches_m, batches_me)}
    torch.cuda.empty_cache()
    out["two_ranks"] = two_ranks_check()
    out["plan_forms"] = plan_forms_check(batch_8, device)
    return out


# -- phase 14: the offline run around train()
CONV_ITERS = 3000  # the gate's recorded run, CONVERGENCE_r05.json
CONV_TRAJECTORY = (500, 1000, 2000, 3000)
PSLABEL_AGREE_MIN = 0.999  # pseudo-labels and nuScenes ground, card vs CPU
NUSC_SCANS = 4
NUSC_BEAMS = 32
NUSC_POINTS = 34720  # 32 beams x 1,085 returns: one nuScenes LiDAR sweep
_ITER_LINE = re.compile(r"iter:\s+(\d+)\s.*seg_iou_3d: (\S+)")


class ConvergenceProbe:
    """Records what the convergence run's ``train()`` does, by wrapping the
    trainer functions it calls: the models it builds, and per step call
    whether it is the EMA step, its start on the host clock and the conv
    kernels' launches by route over the call. The step calls at the
    iterations in ``traced`` (0-based) run under :func:`profile_call`."""

    def __init__(self, traced=()):
        self.models = None
        self.steps = []  # (with_ema, start s, {kernel: {route: launches}})
        self.traced, self.profiles = set(traced), {}
        self._stack = ExitStack()

    def __enter__(self):
        from mopa_tpu_torch.ops import sparse_conv_cuda as scc
        from mopa_tpu_torch.train import trainer

        real_build, real_make = trainer.build_models, trainer.make_train_step

        def build_models(*a, **kw):
            self.models = real_build(*a, **kw)
            return self.models

        def make_train_step(*a, with_ema=False, **kw):
            step = real_make(*a, with_ema=with_ema, **kw)

            def probed(state, *batches):
                before = {k: dict(v) for k, v in scc.routes.items()}
                i = len(self.steps)
                t0 = time.perf_counter()
                if i in self.traced:
                    box = []
                    self.profiles[i] = profile_call(
                        lambda: box.append(step(state, *batches)),
                        trainer.TRAIN_STAGES + trainer.TEACHER_STAGES)
                    result = box[0]
                else:
                    result = step(state, *batches)
                self.steps.append((bool(with_ema), t0, {
                    k: {r: scc.routes[k][r] - n for r, n in v.items()}
                    for k, v in before.items()}))
                return result
            return probed

        self._stack.enter_context(mock.patch.object(
            trainer, "build_models", build_models))
        self._stack.enter_context(mock.patch.object(
            trainer, "make_train_step", make_train_step))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False


def convergence_run(device) -> tuple:
    """(a): ``convergence_check.run`` for :data:`CONV_ITERS` iterations on
    the card; returns (report, trained models)."""
    import logging

    import torch

    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.tools import convergence_check as cc

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.train_iou = {}

        def emit(self, record):
            m = _ITER_LINE.search(record.getMessage())
            if m:
                self.train_iou[int(m.group(1))] = float(m.group(2))

    logger = logging.getLogger("chip_smoke.convergence")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    lines = Lines()
    logger.addHandler(lines)
    log_path = ROOT / "chiprun_out" / "convergence.log"
    log_path.parent.mkdir(exist_ok=True)
    handler = logging.FileHandler(log_path, mode="w")
    logger.addHandler(handler)
    cfg = cc.convergence_cfg(CONV_ITERS)
    ema_start = cfg.TRAIN.PC_MM.ema_start_iter
    traced = (ema_start // 2, (ema_start + CONV_ITERS) // 2)
    try:
        with ConvergenceProbe(traced) as probe:
            scc.reset_launch_counts()
            t0 = time.perf_counter()
            _, eval_dict, result = cc.run(CONV_ITERS, device=device,
                                          logger=logger)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = dict(scc.launches)
    finally:
        logger.removeHandler(handler)
        handler.close()
    n = len(conv_shapes())
    val_batches = math.ceil(cfg.DATASET_TARGET.SyntheticSCN.length
                            / cfg.VAL.BATCH_SIZE)
    # per iteration, each phase: every conv launch on the CUDA-core route
    # (COMPUTE_DTYPE float32), the teacher's forward doubling K1's
    per_iter = {False: {K1: n, K2_DFEATS: n - 1, K2_DW: n},
                True: {K1: 2 * n, K2_DFEATS: n - 1, K2_DW: n}}
    phases = [ema for ema, _, _ in probe.steps]
    if phases != [i >= ema_start for i in range(CONV_ITERS)]:
        fail("the convergence run stepped {} times, {} in the EMA phase"
             .format(len(phases), sum(phases)))
    for i, (ema, _, routes) in enumerate(probe.steps):
        want = {k: {scc.CUDA_CORE: v, scc.TENSOR_CORE: 0}
                for k, v in per_iter[ema].items()}
        if routes != want:
            fail("convergence iteration {} launched {}, want {}".format(
                i + 1, routes, want))
    want_total = {K1: ema_start * n + (CONV_ITERS - ema_start) * 2 * n
                  + val_batches * n,
                  K2_DFEATS: CONV_ITERS * (n - 1), K2_DW: CONV_ITERS * n,
                  P1: 0, P2: 0}
    if launches != want_total:
        fail("the convergence run launched {}, want {}".format(
            launches, want_total))
    starts = [t for _, t, _ in probe.steps]
    iter_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    # each phase's first iteration (loader start, first call) and the traced
    # ones set apart
    pre_ms = [t for i, t in enumerate(iter_ms[1:ema_start - 1], 1)
              if i not in traced]
    ema_ms = [t for i, t in enumerate(iter_ms[ema_start:], ema_start)
              if i not in traced]
    ref = json.loads((ROOT / "CONVERGENCE_r05.json").read_text())
    ev3 = eval_dict["3D"]
    out = {
        "iters": CONV_ITERS, "result": result, "wall_s": wall_s,
        "iteration_median_ms": {"pre_ema": statistics.median(pre_ms),
                                "ema": statistics.median(ema_ms)},
        "launches": launches,
        "traced_steps": {("ema" if i >= ema_start else "pre_ema"): {
            k: prof.get(k) for k in ("wall_ms", "device_busy_ms",
                                     "device_idle_share",
                                     "device_kernel_ms_total", "stages")}
            for i, prof in probe.profiles.items()},
        "launches_per_iteration": {"pre_ema": per_iter[False],
                                   "ema": per_iter[True],
                                   "route": scc.CUDA_CORE},
        "val_3d_class_iou": {name: float(v) for name, v in zip(
            ev3.class_names, ev3.class_iou)},
        "train_iou_3d": {str(i): lines.train_iou.get(i)
                         for i in CONV_TRAJECTORY},
        "reference_train_iou_3d": ref["provenance"][
            "3d_train_iou_trajectory"],
        "reference_miou": ref["miou"]}
    print("convergence ({} iterations, float32, EMA from {}): val mIoU {} "
          "(gate {}; pass {}); 3D val IoU per class {}".format(
              CONV_ITERS, ema_start, result["miou"], result["gate"],
              result["pass"], out["val_3d_class_iou"]), flush=True)
    print("convergence: 3D train IoU at {} {} beside {}'s trajectory {} "
          "(TPU v5e, accuracy only); median iteration ms pre-EMA {:.2f}, "
          "EMA {:.2f}; wall {:.1f} s; launches per iteration (route {}) "
          "pre-EMA {}, EMA {}".format(
              list(CONV_TRAJECTORY), out["train_iou_3d"],
              "CONVERGENCE_r05.json", out["reference_train_iou_3d"],
              out["iteration_median_ms"]["pre_ema"],
              out["iteration_median_ms"]["ema"], wall_s, scc.CUDA_CORE,
              per_iter[False], per_iter[True]), flush=True)
    for name, prof in out["traced_steps"].items():
        if prof["wall_ms"] is None:
            print("convergence: traced {} step: device time not measured "
                  "(no device events traced)".format(name), flush=True)
            continue
        print("convergence: traced {} step {:.2f} ms, device busy {:.2f} ms "
              "(idle share {:.3f}), kernels by stage {}".format(
                  name, prof["wall_ms"], prof["device_busy_ms"],
                  prof["device_idle_share"],
                  {k: v["kernels"] for k, v in prof["stages"].items()
                   if v["kernels"]}), flush=True)
    if not result["pass"]:
        fail("the convergence gate failed: {}".format(result))
    return out, probe.models


def pslabel_check(device, models) -> dict:
    """(b): ``pslabel_update`` with ``entropy_fuse`` over the gate's 32
    target train scans on the card, each file held to the eval pass's
    argmax, then the same weights on the CPU."""
    import logging
    import tempfile

    import numpy as np
    import torch

    from mopa_tpu_torch.data.utils import pslabel_update as psl
    from mopa_tpu_torch.data.utils import validate as val_mod
    from mopa_tpu_torch.tools import convergence_check as cc
    from mopa_tpu_torch.train import trainer

    cfg = cc.convergence_cfg(CONV_ITERS)
    n_scans = cfg.DATASET_TARGET.SyntheticSCN.length
    logger = logging.getLogger("chip_smoke.pslabel")
    logger.propagate = False
    passes = []
    real_step = val_mod.make_eval_step

    def recording_step(cfg_, models_):
        step = real_step(cfg_, models_)

        def wrapped(batch):
            result = step(batch)
            passes.append((result[0].float().cpu().numpy(),
                           result[1].float().cpu().numpy(),
                           batch["num_points"].cpu().numpy()))
            return result
        return wrapped

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        card_dir, cpu_dir = (os.path.join(tmp, d) for d in ("card", "cpu"))
        with mock.patch.object(val_mod, "make_eval_step", recording_step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evals = psl.pslabel_update(cfg, models, logger, card_dir,
                                       entropy_fuse=True)
            torch.cuda.synchronize()
            out["card_ms_per_scan"] = (time.perf_counter() - t0) * 1e3 \
                / n_scans
        names = sorted(os.listdir(card_dir))
        if len(names) != n_scans or len(passes) != n_scans \
                or "xM_ety" not in evals:
            fail("pslabel_update wrote {} files over {} eval batches, "
                 "evaluators {}".format(len(names), len(passes),
                                        list(evals)))
        for name, (p2, p3, num_points) in zip(names, passes):
            data = np.load(os.path.join(card_dir, name),
                           allow_pickle=True).item()
            n = int(num_points[0])
            for d, p in (("2d", p2), ("3d", p3)):
                labels = data["pseudo_label_" + d]
                if labels.shape != (n,) or labels.max() >= NUM_CLASSES:
                    fail("{} {}: {} labels up to {} for {} points".format(
                        name, d, labels.shape, labels.max(), n))
                if not (np.array_equal(labels, p[:n].argmax(-1))
                        and np.array_equal(data["probs_" + d],
                                           p[:n].max(-1))):
                    fail("{} {}: the file is not the eval pass's argmax"
                         .format(name, d))
        # the same weights on the CPU
        cpu_models = trainer.build_models(cfg, device="cpu")
        for got, src in zip(cpu_models[:2], models[:2]):
            got.load_state_dict(src.state_dict())
        t0 = time.perf_counter()
        psl.pslabel_update(cfg, cpu_models, logger, cpu_dir)
        out["cpu_ms_per_scan"] = (time.perf_counter() - t0) * 1e3 / n_scans
        same = total = 0
        for name in names:
            a = np.load(os.path.join(card_dir, name), allow_pickle=True
                        ).item()
            b = np.load(os.path.join(cpu_dir, name), allow_pickle=True
                        ).item()
            for d in ("2d", "3d"):
                same += int((a["pseudo_label_" + d]
                             == b["pseudo_label_" + d]).sum())
                total += b["pseudo_label_" + d].size
    out.update(scans=n_scans, points=total // 2, agreement=same / total,
               differing_labels=total - same)
    print("pslabel_update ({} scans, entropy_fuse): {:.2f} ms per scan on "
          "the card, {:.2f} on the CPU; files = the eval pass's argmax; "
          "card vs CPU labels agree on {:.6f} ({} of {} differ)".format(
              n_scans, out["card_ms_per_scan"], out["cpu_ms_per_scan"],
              out["agreement"], out["differing_labels"], total), flush=True)
    if out["agreement"] < PSLABEL_AGREE_MIN:
        fail("pslabel_update card vs CPU: {}".format(out))
    return out


def nuscenes_scan(seed: int):
    """(N, 5) float32 (x, y, z, intensity, ring) of a 360-degree 32-beam
    sweep, as nuScenes stores one: beams from -30.67 to +10.67 degrees, the
    road 1.84 m below the sensor out to 70 m, boxes and walls in front of a
    third of the returns, walls up to 60 m above the horizon."""
    import numpy as np

    rng = np.random.default_rng(seed)
    per = NUSC_POINTS // NUSC_BEAMS
    elev = np.deg2rad(np.linspace(-30.67, 10.67, NUSC_BEAMS))[:, None]
    az = rng.uniform(-np.pi, np.pi, (NUSC_BEAMS, per))
    down = np.tan(-np.clip(elev, None, -1e-3))
    r = np.where(elev < -0.01, 1.84 / down,
                 rng.uniform(10, 60, (NUSC_BEAMS, per)))
    r = np.clip(r, 0, 70.0)
    hit = rng.random((NUSC_BEAMS, per)) < 0.33
    r = np.where(hit, r * rng.uniform(0.2, 0.9, (NUSC_BEAMS, per)), r)
    r = r * (1 + rng.normal(0, 0.002, (NUSC_BEAMS, per)))
    z = r * np.tan(elev)
    z = np.where(~hit & (elev < -0.01), -1.84 + rng.normal(0, 0.02, z.shape),
                 z)
    ring = np.broadcast_to(np.arange(NUSC_BEAMS)[:, None], z.shape)
    pts = np.stack([r * np.cos(az), r * np.sin(az), z,
                    rng.uniform(0, 255, z.shape), ring], -1)
    return pts.reshape(-1, 5).astype(np.float32)


def nuscenes_ground_check(device) -> dict:
    """(c): ``get_nuscenes_ground`` over :data:`NUSC_SCANS` scans listed in
    a pickle, on the card and on the CPU."""
    import pickle
    import tempfile

    import numpy as np
    import torch

    from mopa_tpu_torch.data.nuscenes.preprocess import get_nuscenes_ground

    out = {}
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "samples", "LIDAR_TOP"))
        records = []
        for i in range(NUSC_SCANS):
            rel = "samples/LIDAR_TOP/n{:03d}.pcd.bin".format(i)
            nuscenes_scan(40 + i).tofile(os.path.join(root, rel))
            records.append({"lidar_path": rel})
        pkl = os.path.join(root, "train_night.pkl")
        with open(pkl, "wb") as f:
            pickle.dump(records, f)
        times = {}
        for name, dev in (("card", device), ("card", device),
                          ("cpu", "cpu")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            get_nuscenes_ground(root, pkl, "g_" + name, device=dev)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3 / NUSC_SCANS
        same = shares = points = 0
        for rec in records:
            n = os.path.getsize(os.path.join(root, rec["lidar_path"])) // 20
            points += n
            masks = []
            for name in ("card", "cpu"):
                idx = np.fromfile(os.path.join(
                    root, "g_" + name, "LIDAR_TOP",
                    os.path.basename(rec["lidar_path"])), np.int32)
                m = np.zeros(n, bool)
                m[idx] = True
                masks.append(m)
            same += int((masks[0] == masks[1]).sum())
            shares += float(masks[1].mean())
    out.update(scans=NUSC_SCANS, points_per_scan=points // NUSC_SCANS,
               card_ms_per_scan=times["card"], cpu_ms_per_scan=times["cpu"],
               agreement=same / points, differing_points=points - same,
               ground_share=shares / NUSC_SCANS)
    print("nuScenes ground ({} scans of {} points): {:.2f} ms per scan on "
          "the card (warm), {:.2f} on the CPU; ground share {:.3f}; card "
          "vs CPU masks agree on {:.6f} ({} points differ)".format(
              NUSC_SCANS, out["points_per_scan"], out["card_ms_per_scan"],
              out["cpu_ms_per_scan"], out["ground_share"], out["agreement"],
              out["differing_points"]), flush=True)
    if out["agreement"] < PSLABEL_AGREE_MIN \
            or not 0.05 < out["ground_share"] < 0.95:
        fail("nuScenes ground on the card: {}".format(out))
    return out


OFFLINE_WORKER = "--offline-worker"
OFFLINE_TIMEOUT_S = 1000  # the worker's (a) and (b), from its start


def offline_worker(out_path: str) -> None:
    """Phase 14 (a) and (b) in a process of their own (``python3
    chip_smoke.py --offline-worker <json>``): the convergence run, then
    ``pslabel_update`` on its weights; the report goes to ``out_path``."""
    import torch

    sys.path.insert(0, str(ROOT))
    from mopa_tpu_torch.data import native_loader
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    scc.build()  # the libraries phase 1 built, loaded
    native_loader.build()
    out = {}
    out["convergence"], models = convergence_run(device)
    out["pslabel"] = pslabel_check(device, models)
    Path(out_path).write_text(json.dumps(out))


def start_offline_worker() -> dict:
    """Start :func:`offline_worker`; its output goes to
    ``chiprun_out/offline_worker.log``."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    worker = {"json": out_dir / "offline_worker.json",
              "log": out_dir / "offline_worker.log",
              "t0": time.perf_counter()}
    if worker["json"].exists():
        worker["json"].unlink()
    worker["file"] = open(worker["log"], "w")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), OFFLINE_WORKER,
         str(worker["json"])], cwd=ROOT, stdout=worker["file"],
        stderr=subprocess.STDOUT)
    # a failing phase exits the script: the worker goes with it
    atexit.register(lambda: proc.poll() is None and proc.kill())
    worker["proc"] = proc
    return worker


def offline_phase(device, worker: dict) -> dict:
    """Phase 14: (a) the convergence gate and (b) ``pslabel_update`` on the
    trained weights, from the worker started after phase 3; then (c)
    nuScenes ground extraction on the card."""
    proc = worker["proc"]
    try:
        rc = proc.wait(timeout=max(
            1.0, OFFLINE_TIMEOUT_S - (time.perf_counter() - worker["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    finally:
        worker["file"].close()
    text = worker["log"].read_text()
    print(text.strip(), flush=True)
    if rc != 0 or not worker["json"].exists():
        fail("the phase 14 worker ended with {} (log {})".format(
            "a timeout" if rc is None else "exit code {}".format(rc),
            worker["log"]))
    out = json.loads(worker["json"].read_text())
    out["worker_wall_s"] = time.perf_counter() - worker["t0"]
    out["nuscenes_ground"] = nuscenes_ground_check(device)
    return out


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if not (ROOT / "mopa_tpu_torch" / "csrc").is_dir():
        fail("run from a checkout of the repository (mopa_tpu_torch missing)")
    sys.path.insert(0, str(ROOT))

    from mopa_tpu_torch.data import native_loader, synthetic
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.train import trainer
    from mopa_tpu_torch.train.common import decode_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    report = {"card": card_line(), "phase_s": {}}
    print(report["card"], flush=True)
    last = [time.perf_counter()]

    def lap(name):
        """Seconds since the previous lap, kept as phase ``name``'s."""
        now = time.perf_counter()
        report["phase_s"][name] = now - last[0]
        last[0] = now

    # -- phase 1: build
    t0 = time.perf_counter()
    scc.build()
    report["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_loader.build()
    report["host_plan_build_s"] = time.perf_counter() - t0
    report["ptxas"] = {}
    for name in scc.SOURCES:
        log = scc.library_path(name).with_suffix(".log")
        report["ptxas"][name] = log.read_text() if log.exists() \
            else "(cached build)"
    print("kernel build ({} sources in parallel): {:.2f} s; host plan "
          "builder (c++): {:.2f} s".format(len(scc.SOURCES), report["build_s"],
                                           report["host_plan_build_s"]))
    for text in report["ptxas"].values():
        print(text.strip())
    report["kernel_build"] = kernel_report()
    print("kernels (registers, spilled bytes, stack frame, tensor-core MMA "
          "instructions): {}".format(report["kernel_build"]), flush=True)
    lap("build")

    # -- data: 3 single-scan requests, one batch of 8 scans, and the fused
    # 8 + 8 scan plan of a train step (source and target BN domains)
    batches_1 = [synthetic.eval_batch(1, POINT_BUDGET, start_index=i,
                                      image_size=IMAGE_SIZE) for i in range(3)]
    batch_8 = synthetic.eval_batch(8, POINT_BUDGET, start_index=3,
                                   image_size=IMAGE_SIZE)
    t0 = time.perf_counter()
    batches_t = train_batches(COUNTED_STEPS, TRAIN_BATCH, 100)
    batches_e = train_batches(EMA_COUNTED_STEPS, TRAIN_BATCH, 200,
                              with_ema=True)
    report["train_data_s"] = time.perf_counter() - t0
    # the shipped MoPA step's batches: VGI on, the loader's host work done
    cfg_m = make_cfg("bfloat16", train=True, vgi=True)
    batches_m, host_m = mopa_batches(COUNTED_STEPS, 500, False, cfg_m)
    batches_me, host_me = mopa_batches(EMA_COUNTED_STEPS, 600, True, cfg_m)
    print("host work per MoPA batch pair (8 + 8 scans, 8 cat scans): {}; "
          "EMA pairs: {}".format(host_m, host_me), flush=True)
    cfg = make_cfg("bfloat16")
    lap("data")

    # -- phase 2: the gather probes
    report["gather"] = gather_phase(device)
    torch.cuda.empty_cache()
    lap("gather")

    # -- phase 3: each conv kernel against its plain twin at every conv shape
    plans = {}
    for name, batch in (("batch1", batches_1[0]), ("batch8", batch_8)):
        b, p = batch["img_indices"].shape[:2]
        valid = torch.from_numpy(valid_mask(batch)).to(device)
        coords = torch.from_numpy(batch["coords"]).to(device)
        plans[name] = trainer.build_plan_from_batch(cfg, coords, valid, p)
    # the shipped step's fused plan: 8 + 8 scans, then the 8 cat scans
    plans["mopa24"] = trainer.build_train_plan(
        cfg_m, *(decode_batch(b, device) for b in batches_m[0]), True)[0]
    for name, plan in plans.items():
        report["num_voxels_" + name] = plan.num_voxels.tolist()
        report["rows_" + name] = [lv.valid.shape[0] for lv in plan.levels]
    print("plan rows per level: {}".format(
        {k: report["rows_" + k] for k in plans}), flush=True)
    rows = kernel_phase(plans, "mopa24", device)
    report["kernel_rows"] = rows
    del plans
    lap("kernels")

    # -- phase 14 (a) and (b) start here, in a process of their own: the
    # convergence run is host-bound for ~12 minutes, and runs beside
    # phases 4-13 (its results are read after phase 13)
    worker = start_offline_worker()

    # -- phase 4: the eval step
    report["eval"] = eval_phase(batches_1, batch_8, device)
    torch.cuda.empty_cache()
    lap("eval")

    # -- phase 5: the train step
    report["train"] = train_phase(batches_t, device)
    torch.cuda.empty_cache()
    lap("train")

    # -- phase 6: the EMA phase of the train step
    report["ema"] = train_phase(batches_e, device, with_ema=True)
    torch.cuda.empty_cache()
    lap("ema")

    # -- phases 7 and 8: the shipped MoPA step, VGI on, host-built plans,
    # before and after the EMA switch
    for key, batches, host, with_ema in (("mopa", batches_m, host_m, False),
                                         ("mopa_ema", batches_me, host_me,
                                          True)):
        report[key] = {"host": host,
                       "plans_agree": host_plans_agree(*batches[0], device)}
        report[key].update(train_phase(batches, device, with_ema=with_ema,
                                       vgi=True))
        torch.cuda.empty_cache()
        lap(key)

    # -- phase 9: the shipped MoPA step fed by the loaders, across the switch
    report["loader"] = loader_phase(device, report)
    torch.cuda.empty_cache()
    lap("loader")

    # -- phase 10: the training and eval drivers, the CLIs
    report["driver"] = driver_phase(device, report)
    torch.cuda.empty_cache()
    lap("driver")

    # -- phase 11: device VGI (the step's route without a host cat plan)
    report["device_vgi"] = device_vgi_phase(
        device, report, {"mopa": batches_m, "mopa_ema": batches_me})
    torch.cuda.empty_cache()
    lap("device_vgi")

    # -- phase 12: Segment-Anything (no kernel of the repo on its path)
    report["sam"] = sam_phase(device)
    torch.cuda.empty_cache()
    lap("sam")

    # -- phase 13: SPVCNN (K1 / K2 above 192 channels), SalsaNext, the depth
    # head
    report["backbones"] = backbone_phase(device, report, batches_m[0][1])
    torch.cuda.empty_cache()
    lap("backbones")

    # -- phase 15: data parallelism (one rank over NCCL, two over gloo)
    # and the other plan forms; the phase 14 worker runs on beside it
    report["data_parallel"] = dp_phase(device, batches_m, batches_me,
                                       batch_8)
    torch.cuda.empty_cache()
    lap("data_parallel")

    # -- phase 14: the convergence gate, pslabel_update, nuScenes ground
    report["offline"] = offline_phase(device, worker)
    torch.cuda.empty_cache()
    lap("offline")

    # -- summary lines; each conv kernel at the shapes the shipped step
    # gives it (the fused 8 + 8 + 8-scan plan, bfloat16) with its launches
    # in phase 7, each probe kernel at the probe's
    train_launches = report["mopa"]["launches"]

    def main_rows(kernel, dtype="bfloat16"):
        return [r for r in rows if r["kernel"] == kernel
                and r["plan"] == "mopa24" and r["dtype"] == dtype
                and not (kernel == K2_DFEATS and r["conv"] == "stem")]

    src_conv = "mopa_tpu_torch/csrc/submanifold_conv.cu"
    conv_kernels = (
        (K1, src_conv, "mopa_tpu/ops/sparse_conv_pallas.py:75"),
        (K2_DFEATS, src_conv, "mopa_tpu/ops/sparse_conv_pallas.py:96"),
        (K2_DW, "mopa_tpu_torch/csrc/submanifold_conv_dw.cu",
         "mopa_tpu/ops/sparse_conv_pallas.py:96"))
    kernels = [kernel_entry(name, main_rows(name), train_launches[name],
                            source, replaces)
               for name, source, replaces in conv_kernels]
    # the float32 (CUDA-core) route at the same shapes, checked and timed
    # in phase 3 but off the main path: in the JSON report only
    report["kernels_f32"] = [
        kernel_entry(name, main_rows(name, "float32"), 0, source, replaces)
        for name, source, replaces in conv_kernels]
    probes = report["gather"]
    for name, key, line, library_ms in (
            (P1, "gather", 83, probes["library"]["index_select_ms"]),
            (P2, "fused", 124, None)):
        r = probes[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mopa_tpu_torch/csrc/gather_micro.cu",
            "replaces": "tools/gather_micro.py:{}".format(line),
            "launches": probes["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "bound_share": r["bound_ms"] / r["ms"],
            "library_ms": library_ms})
    report["kernels"] = kernels
    print("phase seconds: {}".format(report["phase_s"]), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == [OFFLINE_WORKER]:
        offline_worker(sys.argv[2])
    elif sys.argv[1:2] == [DP_WORKER]:
        dp_worker(sys.argv[2])
    else:
        main()
