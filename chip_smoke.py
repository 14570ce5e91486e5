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
10. Print the kernels line (JSON; ``route`` is the build route, ``cuda``,
   and ``kernel_route`` the conv kernels' route on the main path, whose
   launches are phase 7's), the card line, then ``{"ok": true, "device":
   {...}}`` as the last line.

Weights are random from a seed. Details go to ``chiprun_out/chip_smoke.json``.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import importlib.util
import json
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

    from mopa_tpu_torch.ops import sparse_conv as sc
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.tools import gather_micro as gm

    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for plan_name, plan in plans.items():
        for name, level, cin, cout in conv_shapes():
            lv = plan.levels[level]
            v = lv.valid.shape[0]
            codes = lv.sel.long()
            pairs = sum(int((((codes >> (2 * j)) & 3) != 3).sum())
                        for j in range(3))
            plan_bytes = 2 * v * 9 * 4
            # (tile, column) blocks the tensor-core conv kernel stages
            col_tiles = int(scc.tile_columns(lv.ranks, lv.sel, v).sum())
            for dtype in (torch.float32, torch.bfloat16):
                dt_name = str(dtype).split(".")[-1]
                tag = "{} {} {}".format(plan_name, name, dt_name)
                esz = torch.tensor([], dtype=dtype).element_size()
                # batch norm writes its bias into padding rows: no input
                # row is zero, padding included
                feats = torch.randn((v, cin), generator=gen, device=device
                                    ).to(dtype)
                w = (torch.randn((27, cin, cout), generator=gen,
                                 device=device)
                     * (2.0 / (27 * cin)) ** 0.5).to(dtype)
                g = torch.randn((v, cout), generator=gen, device=device
                                ).to(dtype)
                cases = [(K1, True,
                          lambda: scc.submanifold_conv_wide_cuda(
                              feats, lv.ranks, lv.sel, w),
                          lambda: sc.submanifold_conv_wide_ref(
                              feats, lv.ranks, lv.sel, w),
                          (v * cin + 27 * cin * cout + v * cout) * esz
                          + plan_bytes)]
                if plan_name == backward_plan:
                    cases += [
                        (K2_DFEATS, True,
                         lambda: scc.submanifold_conv_wide_bwd_dfeats_cuda(
                             g, lv.ranks, lv.sel, w),
                         lambda: sc.submanifold_conv_wide_dfeats_ref(
                             g, lv.ranks, lv.sel, w),
                         (v * cout + 27 * cin * cout + v * cin) * esz
                         + plan_bytes),
                        (K2_DW, False,
                         lambda: scc.submanifold_conv_wide_bwd_dw_cuda(
                             g, feats, lv.ranks, lv.sel),
                         lambda: sc.submanifold_conv_wide_dw_ref(
                             g, feats, lv.ranks, lv.sel),
                         (v * cout + v * cin) * esz + 27 * cin * cout * 4
                         + plan_bytes)]
                for kernel, elementwise, kern, plain, nbytes in cases:
                    got, ref = kern(), plain()
                    torch.cuda.synchronize()
                    err, ref_max, tol = _check(kernel, tag, got, ref,
                                               elementwise)
                    row = {
                        "kernel": kernel, "plan": plan_name, "conv": name,
                        "cin": cin, "cout": cout, "voxel_rows": v,
                        "neighbour_pairs": pairs, "dtype": dt_name,
                        "route": scc.route_for(dtype),
                        "max_abs_err": err, "max_abs_ref": ref_max,
                        "tolerance": tol,
                        "ms": gm.median_ms(kern, TIMED_LAUNCHES, device),
                        "plain_ms": gm.median_ms(plain, TIMED_LAUNCHES,
                                                 device),
                        "bytes_ms": nbytes / gm.HBM_BYTES_PER_S * 1e3,
                        "ops_ms": 2 * cin * cout * pairs
                        / gm.PEAK_FLOPS[dt_name] * 1e3}
                    row["bound_share"] = max(row["bytes_ms"],
                                             row["ops_ms"]) / row["ms"]
                    if kernel != K2_DW:
                        # the dense MMA work of the staged (tile, column)
                        # blocks: 3 slots x all channels, pairs or not
                        kp, np_ = scc.conv_tile_shape(
                            *((cin, cout) if kernel == K1 else (cout, cin)))
                        row["tile_ops_ms"] = (
                            2 * col_tiles * scc.TILE_M * kp * np_
                            / gm.PEAK_FLOPS["bfloat16"] * 1e3)
                    if kernel == K2_DW and name == "l0_conv2":
                        again = kern()
                        row["same_bits_on_rerun"] = bool(torch.equal(got,
                                                                     again))
                        if not row["same_bits_on_rerun"]:
                            fail("K2 d_w gave other bits on a rerun at "
                                 + tag)
                    rows.append(row)
                    print("{kernel} {plan} {conv} ({cin},{cout}) {dtype} "
                          "[{route}]: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                          "bound {b:.4f} ms, share {bound_share:.3f}) "
                          "max|err| {max_abs_err:.3g}".format(
                              b=max(row["bytes_ms"], row["ops_ms"]), **row),
                          flush=True)
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
    its range. ``device_kernel_ms`` sums a stage's kernels,
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

    # -- phase 10: summary lines; each conv kernel at the shapes the shipped
    # step gives it (the fused 8 + 8 + 8-scan plan, bfloat16) with its
    # launches in phase 7, each probe kernel at the probe's
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
    main()
