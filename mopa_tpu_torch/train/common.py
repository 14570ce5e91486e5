"""The training driver and the batches it feeds the card (PyTorch port of
``mopa_tpu/train/common.py``; reference ``mopa/train/train_xmuda_mopa.py``,
``train_xmuda.py``, ``train_baseline.py``).

:func:`train` builds the models, the loaders, the train state and its two
checkpoint streams, and runs the iteration loop: logging, checkpoints and
validation, and MoPA's switch to the EMA teacher step at
``ema_start_iter``; :func:`main_common` is the train CLIs' entry point.
Under ``torchrun`` with ``TPU.DATA_PARALLEL`` N (or 0) a run trains
data-parallel over the N processes (``parallel.mesh``), each on its card
``cuda:LOCAL_RANK``; rank 0 alone writes the log, the checkpoints and the
IoU table, and validates the whole val split.

``device_batch`` ships a collated numpy batch in its compact wire dtypes,
without what the step can derive or never reads; ``device_prefetch`` does
that for a loader's batches ahead of the consumer, on a thread and, on a
card, on a side CUDA stream from pinned host memory. ``decode_batch`` (the
first stage of every step) widens a wire batch to compute dtypes on the
card and rebuilds what was left out.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from mopa_tpu_torch.common.checkpoint import CheckpointerV2
from mopa_tpu_torch.common.config import purge_cfg
from mopa_tpu_torch.common.metric_logger import MetricLogger, iou_to_excel
from mopa_tpu_torch.common.rng import set_random_seed
from mopa_tpu_torch.common.run_ahead import run_ahead
from mopa_tpu_torch.common.spans import span
from mopa_tpu_torch.config.xmuda import cfg as default_cfg
from mopa_tpu_torch.data.build import build_dataloader
from mopa_tpu_torch.models.build import plan_batch_keys
from mopa_tpu_torch.models.metric import SegIoU
from mopa_tpu_torch.parallel import mesh as mesh_mod

_INT_KEYS = ("coords", "img_indices", "seg_label", "pseudo_label_2d",
             "pseudo_label_3d", "sam_mask", "ema_map", "ori_coords",
             "ori_img_indices", "ori_pseudo_label_3d", "hp_counts",
             "hp_inverse", "hp_ori_counts", "hp_ori_inverse", "proj_xy",
             "cat_label", "hp_cat_counts", "hp_cat_inverse")

# Keys only the EMA teacher reads (its unaugmented inputs and their host-built
# plans); the student step never sees them.
EMA_ONLY_KEYS = ("ori_img", "ori_img_indices", "ori_coords", "ori_batch_idx",
                 "ori_point_valid", "ori_feats", "ema_map", "ori_num_points",
                 "ori_feats_ones")
EMA_ONLY_PREFIX = "hp_ori_"


# Derivable on the card from the (B, P) layout: never shipped.
_DERIVED_KEYS = ("batch_idx", "ori_batch_idx")

PREFETCH_DEPTH = 1  # batches device_prefetch copies ahead of its consumer


def is_ema_key(key: str) -> bool:
    return key in EMA_ONLY_KEYS or key.startswith(EMA_ONLY_PREFIX)


def _wire_arrays(batch: dict, strip_ema: bool = False,
                 strip_keys=(), keep_keys=()) -> dict:
    """The arrays of a collated numpy batch that cross to the card, as the
    JAX package's ``device_batch`` picks them: no host-only ("_") key, no
    derivable ``batch_idx``/``ori_batch_idx``, none of ``strip_keys``, none
    of the EMA teacher's keys with ``strip_ema``; no voxel coordinates of a
    group whose host-built plan is shipped (unless in ``keep_keys``, the
    3D net's ``models.build.plan_batch_keys``); no validity mask that its
    count rebuilds (``ori_points_valid`` from ``vgi_num_points`` too); and
    an all-ones feature column of at most 8 channels as the (B, C) float16
    ``feats_ones`` / ``ori_feats_ones`` marker."""
    def keep(k):
        if k.startswith("_") or k in _DERIVED_KEYS or k in strip_keys:
            return False
        if strip_ema and is_ema_key(k):
            return False
        if k in keep_keys:
            return True
        if k == "coords" and "hp_rankn" in batch:
            return False
        if k == "ori_coords" and "hp_ori_rankn" in batch:
            return False
        if k == "point_valid" and "num_points" in batch \
                and "img_indices" in batch:
            return False
        if k == "ori_point_valid" and "ori_num_points" in batch \
                and "ori_img_indices" in batch:
            return False
        if k == "ori_points_valid" and "vgi_num_points" in batch \
                and "ori_points" in batch:
            return False
        return True

    out = {k: v for k, v in batch.items() if keep(k)}
    if "num_points" in out:
        b = np.asarray(out["num_points"]).shape[0]
        for fk, mk in (("feats", "feats_ones"),
                       ("ori_feats", "ori_feats_ones")):
            f = out.get(fk)
            if f is not None and getattr(f, "ndim", 0) == 2 \
                    and f.shape[1] <= 8 and np.all(np.asarray(f) == 1):
                del out[fk]
                out[mk] = np.ones((b, f.shape[1]), np.float16)
    return out


def device_batch(batch: dict, device="cuda", strip_ema: bool = False,
                 strip_keys=(), keep_keys=()) -> dict:
    """Copy the :func:`_wire_arrays` of a collated numpy batch to
    ``device`` as tensors of the same dtypes. On a card each array goes
    through pinned host memory and a ``non_blocking`` copy on the current
    stream; on the CPU each is a plain copy."""
    device = torch.device(device)
    out = {}
    for k, v in _wire_arrays(batch, strip_ema, strip_keys,
                             keep_keys).items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.clone()
    return out


def device_prefetch(iterator, device="cuda", strip_ema: bool = False,
                    strip_keys=(), keep_keys=()):
    """Yield :func:`device_batch` of each batch of ``iterator``, made up to
    :data:`PREFETCH_DEPTH` batches ahead on a thread of its own.

    On a card the thread copies on a side CUDA stream; the consumer's
    current stream waits on an event recorded after a batch's copies before
    the batch is yielded, and each of its tensors is marked used on that
    stream (``record_stream``), so the caching allocator does not hand its
    memory to a later copy while the consumer's kernels may still read it.
    An exception in the thread (or in ``iterator``) is raised in the
    consumer. A consumer that stops early stops the thread, which then
    closes its iterator of ``iterator`` (a loader's generator stops its
    producer so)."""
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def produce(put):
        it = iter(iterator)
        try:
            for b in it:
                if side is None:
                    item = (device_batch(b, device, strip_ema, strip_keys,
                                         keep_keys), None)
                else:
                    with torch.cuda.device(device), torch.cuda.stream(side):
                        t = device_batch(b, device, strip_ema, strip_keys,
                                         keep_keys)
                        ready = torch.cuda.Event()
                        ready.record(side)
                    item = (t, ready)
                if not put(item):
                    return
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    for batch, ready in run_ahead(produce, PREFETCH_DEPTH, "mopa-prefetch"):
        if ready is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(ready)
            for t in batch.values():
                t.record_stream(stream)
        yield batch


def decode_batch(batch: dict, device) -> dict:
    """Copy a collated batch to ``device`` and widen it to compute dtypes.

    Accepts numpy arrays or tensors in the wire format: uint8 images
    (``img``, ``ori_img``) become float32 in [0, 1]; integer keys (the
    compact int16 ``inverse``/``counts`` of host plans and ``cat_label``
    among them) become int64; ``point_valid``/``ori_point_valid`` are
    rebuilt from ``num_points``/``ori_num_points`` when absent; an all-ones
    SCN feature column shipped as the (B, C) ``feats_ones``/
    ``ori_feats_ones`` marker is expanded; ``batch_idx``/``ori_batch_idx`` are derived from the (B, P)
    layout when absent. The raw VGI scan ``ori_points`` is widened from its
    int16 fixed point, and ``ori_points_valid`` rebuilt from
    ``vgi_num_points`` when absent. Keys starting with "_" stay on the host
    side and are dropped.
    """
    out = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else torch.as_tensor(v)
        out[k] = t.to(device, non_blocking=True)
    for k in ("img", "ori_img"):
        if k in out and out[k].dtype == torch.uint8:
            out[k] = out[k].float() / 255.0
    for k in _INT_KEYS:
        if k in out:
            out[k] = out[k].long()
    if "ori_points" in out and out["ori_points"].dtype == torch.int16:
        # the raw VGI scan's int16 fixed point: 5 mm in xyz, 1/32000 in
        # intensity
        q = out["ori_points"].float()
        out["ori_points"] = torch.cat([q[..., :3] * 0.005,
                                       q[..., 3:] * (1.0 / 32000.0)], dim=-1)
    if "ori_points_valid" not in out and "vgi_num_points" in out \
            and "ori_points" in out:
        p = out["ori_points"].shape[1]
        out["ori_points_valid"] = (torch.arange(p, device=device)[None, :]
                                   < out["vgi_num_points"][:, None])
    for pre in ("", "ori_"):
        feats, valid = pre + "feats", pre + "point_valid"
        if feats in out:
            out[feats] = out[feats].float()
        if valid not in out and pre + "num_points" in out \
                and pre + "img_indices" in out:
            p = out[pre + "img_indices"].shape[1]
            out[valid] = (torch.arange(p, device=device)[None, :]
                          < out[pre + "num_points"][:, None])
        if feats not in out and pre + "feats_ones" in out and valid in out:
            b, c = out[pre + "feats_ones"].shape
            p = out[valid].shape[1]
            out[feats] = torch.ones((b * p, c), device=device)
    if "point_valid" in out and "batch_idx" not in out:
        b, p = out["point_valid"].shape
        out["batch_idx"] = torch.arange(b, device=device).repeat_interleave(p)
    if "ori_point_valid" in out and "ori_batch_idx" not in out \
            and "ori_coords" in out:
        b, p = out["ori_point_valid"].shape
        out["ori_batch_idx"] = torch.arange(
            b, device=device).repeat_interleave(p)
    return out


def parse_args(description, default_cfg_path, with_test_args=False):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--cfg", dest="config_file", default=default_cfg_path,
                        metavar="FILE", help="path to config file", type=str)
    parser.add_argument("opts",
                        help="Modify config options from the command line",
                        default=None, nargs=argparse.REMAINDER)
    parser.add_argument("--task", default="MoPA", type=str)
    parser.add_argument("--resume_dir", default=None, type=str)
    if with_test_args:
        parser.add_argument("--model_prefix", default="", type=str)
        parser.add_argument("--ckpt2d", default="", type=str)
        parser.add_argument("--ckpt3d", default="", type=str)
        parser.add_argument("--pselab_dir", default=None, type=str)
    return parser.parse_args()


def load_cfg(args):
    """The default config with ``args.config_file`` and ``args.opts``
    merged, purged of the unselected ``TYPE`` variants, frozen."""
    c = default_cfg.clone()
    c.merge_from_file(args.config_file)
    c.merge_from_list(args.opts or [])
    purge_cfg(c)
    c.freeze()
    return c


def prepare_output_dir(cfg, args):
    """(models dir, run name, log file): ``args.resume_dir``, or a new
    ``OUTPUT_DIR/models/<mmdd><config path>_torch[-n]``, with its
    ``logs/`` made."""
    if args.resume_dir is not None:
        models_output_dir = args.resume_dir
    else:
        models_output_dir = osp.join(cfg.OUTPUT_DIR, "models")
        month_day = time.strftime("%m%d")
        spec = osp.splitext(args.config_file)[0].replace("/", "_")
        spec = month_day + spec + "_torch"
        models_output_dir = osp.join(models_output_dir, spec)
        flag = 1
        while osp.isdir(models_output_dir):
            models_output_dir = models_output_dir + "-" + str(flag)
            flag += 1
        os.makedirs(models_output_dir, exist_ok=True)
    logs_dir = osp.join(models_output_dir, "logs")
    os.makedirs(logs_dir, exist_ok=True)
    run_name = "{:s}-{:s}".format(socket.gethostname(), time.strftime("%m%d"))
    log_file = osp.join(logs_dir, "{}_train_{}.log".format(args.task,
                                                           run_name))
    return models_output_dir, run_name, log_file


def host_metrics(metrics: dict) -> dict:
    """A step's metrics on the host as numpy, in one device -> host copy
    (span ``sync/metrics_to_host``): the 0-d metrics and the confusion
    matrices go out stacked as float64 (exact for counts below 2**53) and
    come back in their own dtypes."""
    names = list(metrics)
    flat = torch.cat([metrics[k].reshape(-1).double() for k in names])
    with span("sync/metrics_to_host"):
        host = flat.cpu().numpy()
    out, i = {}, 0
    for k in names:
        t = metrics[k]
        n = t.numel()
        dtype = np.int64 if not t.is_floating_point() else np.float32
        out[k] = host[i:i + n].astype(dtype).reshape(tuple(t.shape))
        i += n
    return out


def _close(*iterators) -> None:
    """Close device_prefetch generators: each stops its thread, which
    closes its loader's generator and so stops the loader's threads."""
    for it in iterators:
        if it is not None:
            it.close()


def train(cfg, logger, output_dir="", run_name="", variant="mopa",
          device="cuda"):
    """Train ``variant`` ("baseline", "xmuda" or "mopa") as ``cfg`` says,
    on ``device`` (the card unless the caller asks for the CPU; a bare
    "cuda" is ``cuda:LOCAL_RANK``). Resumes from the pointer files in
    ``output_dir`` (``AUTO_RESUME``) or from ``RESUME_PATH``; saves both
    streams every ``TRAIN.CHECKPOINT_PERIOD`` iterations and at the end,
    validates every ``VAL.PERIOD`` iterations and at the end (keeping the
    best-metric checkpoints from half way on), and writes
    ``val_class_iou.xlsx``. Returns (state, the last validation's
    ``eval_dict``).

    Data parallel (``parallel.mesh.make_data_mesh(cfg)`` gives a mesh, the
    process group up): every rank loads the checkpoints and steps on its
    block of each batch; rank 0 alone saves (the other ranks wait at a
    barrier after each save) and validates the whole val split, which
    gives the one-process result (the other ranks wait at a barrier and
    return an empty ``eval_dict``).

    The loop's ``time`` meter is each iteration's wall time up to its
    metrics on the host (the step's device work included), its ``data``
    meter the part of it spent waiting for the next batch of both streams
    (span ``loop/next_batch``). Loaders and
    their prefetch threads are closed at the EMA switch, at the end and
    on an exception."""
    # trainer and validate import this module (decode_batch)
    from mopa_tpu_torch.data.utils.validate import validate
    from mopa_tpu_torch.train import trainer as trainer_mod

    mesh = mesh_mod.make_data_mesh(cfg)
    if mesh is None and mesh_mod.world_size() > 1:
        raise RuntimeError(
            "TPU.DATA_PARALLEL {} under a process group of {} ranks: each "
            "rank would train alone (set it to 0 or {})".format(
                cfg.TPU.DATA_PARALLEL, mesh_mod.world_size(),
                mesh_mod.world_size()))
    lead = mesh is None or mesh.rank == 0

    def sync():
        if mesh is not None:
            dist.barrier(group=mesh.group)

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = mesh_mod.local_device()
    if mesh is not None:
        logger.info("Data-parallel mesh: {} ranks over {}".format(
            mesh.size, mesh.backend))
    set_random_seed(cfg.RNG_SEED)
    models = trainer_mod.build_models(cfg, device=device)
    metric_2d = SegIoU(cfg.MODEL_2D.NUM_CLASSES, name="seg_iou_2d")
    metric_3d = SegIoU(cfg.MODEL_3D.NUM_CLASSES, name="seg_iou_3d")
    logger.info("Build 2D model: {}".format(cfg.MODEL_2D.TYPE))
    logger.info("Build 3D model: {}".format(cfg.MODEL_3D.TYPE))
    state = trainer_mod.create_train_state(cfg, models)
    n_params_2d = sum(p.numel() for p in state.params_2d.values())
    n_params_3d = sum(p.numel() for p in state.params_3d.values())
    logger.info("Parameters: 2D {:.2e}  3D {:.2e}".format(n_params_2d,
                                                         n_params_3d))

    # checkpointers (two streams, reference train_xmuda_mopa.py:140-155)
    ck2d = CheckpointerV2(trainer_mod.CheckpointAdapter("2d", models, state),
                          save_dir=output_dir, logger=logger, postfix="_2d",
                          max_to_keep=cfg.TRAIN.MAX_TO_KEEP)
    ckpt_data_2d = ck2d.load(cfg.RESUME_PATH, resume=cfg.AUTO_RESUME,
                             resume_states=cfg.RESUME_STATES)
    ck3d = CheckpointerV2(trainer_mod.CheckpointAdapter("3d", models, state),
                          save_dir=output_dir, logger=logger, postfix="_3d",
                          max_to_keep=cfg.TRAIN.MAX_TO_KEEP)
    ckpt_data_3d = ck3d.load(cfg.RESUME_PATH, resume=cfg.AUTO_RESUME,
                             resume_states=cfg.RESUME_STATES)
    start_iteration = int(ckpt_data_2d.get("iteration", 0))
    ckpt_period = cfg.TRAIN.CHECKPOINT_PERIOD

    # data: the SOURCE stream never feeds the EMA teacher (the reference
    # regenerates target pseudo-labels only, train_xmuda_mopa.py:264-335);
    # the TARGET stream carries the teacher's inputs from ema_start_iter on
    set_random_seed(cfg.RNG_SEED)
    max_iteration = cfg.SCHEDULER.MAX_ITERATION
    ema_start = (cfg.TRAIN.PC_MM.ema_start_iter if variant == "mopa"
                 else max_iteration + 1)
    has_trg = variant != "baseline" and len(cfg.DATASET_TARGET.TRAIN) > 0
    val_period = cfg.VAL.PERIOD
    with_val = val_period > 0 and len(cfg.DATASET_TARGET.VAL) > 0
    val_loader = (build_dataloader(cfg, "val", "target")
                  if with_val and lead else None)

    with_pl = variant != "baseline" and cfg.TRAIN.XMUDA.lambda_pl > 0
    step_pre = trainer_mod.make_train_step(cfg, models, with_pl=with_pl,
                                           with_ema=False,
                                           with_mopa=variant == "mopa",
                                           mesh=mesh)
    step_ema = None

    best_metric_name = "best_{}".format(cfg.VAL.METRIC)
    best_metric = {"2d": ckpt_data_2d.get(best_metric_name),
                   "3d": ckpt_data_3d.get(best_metric_name), "xM": None}
    best_metric_iter = {"2d": -1, "3d": -1, "xM": -1}

    # TensorBoard summaries (reference train_xmuda_mopa.py:159-163,615-620)
    summary_writer = None
    if output_dir and cfg.TRAIN.SUMMARY_PERIOD > 0 and lead:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logger.info("tensorboard unavailable; skipping summaries")
        else:
            summary_writer = SummaryWriter(
                osp.join(output_dir, "tb.{:s}".format(run_name)))

    train_metric_logger = MetricLogger(delimiter="  ")
    val_metric_logger = MetricLogger(delimiter="  ")
    logger.info("Start training from iteration {}".format(start_iteration))

    def streams(start, ema):
        """(source, target) device_prefetch streams of loaders at
        ``start``; before the EMA phase without the teacher's inputs."""
        src = device_prefetch(build_dataloader(
            cfg, "train", "source", start_iteration=start, want_ema=False,
            **shard), device, strip_ema=True, keep_keys=keep)
        trg = None
        if has_trg:
            trg = device_prefetch(build_dataloader(
                cfg, "train", "target", start_iteration=start,
                want_ema=ema, **shard), device, strip_ema=not ema,
                strip_keys=("seg_label",), keep_keys=keep)
        return src, trg

    in_ema = start_iteration >= ema_start
    shard = {} if mesh is None else {"mesh": mesh}  # each rank's block
    keep = plan_batch_keys(cfg)  # what the 3D net's plan stage reads
    src_iter, trg_iter = streams(start_iteration, in_ema)
    eval_dict = {}
    end = time.time()
    try:
        for iteration in range(start_iteration, max_iteration):
            if iteration >= ema_start and not in_ema:
                # EMA phase switch: the loaders restart at this iteration
                # with the teacher's inputs on the target stream (prefetched
                # batches without them are dropped; the samplers stay
                # aligned, as on a resume)
                in_ema = True
                _close(src_iter, trg_iter)
                src_iter, trg_iter = streams(iteration, True)
            with span("loop/next_batch"):
                batch_src = next(src_iter)
                batch_trg = next(trg_iter) if has_trg else batch_src
            data_time = time.time() - end

            if iteration >= ema_start:
                if step_ema is None:
                    step_ema = trainer_mod.make_train_step(
                        cfg, models, with_pl=True, with_ema=True,
                        with_mopa=True, mesh=mesh)
                state, metrics = step_ema(state, batch_src, batch_trg)
            else:
                state, metrics = step_pre(state, batch_src, batch_trg)

            cur_iter = iteration + 1
            metrics = host_metrics(metrics)
            batch_time = time.time() - end
            metric_2d.update_mat(metrics.pop("cm_src_2d"))
            metric_3d.update_mat(metrics.pop("cm_src_3d"))
            train_metric_logger.update(time=batch_time, data=data_time,
                                       **metrics)

            if cur_iter == 1 or (cfg.TRAIN.LOG_PERIOD > 0
                                 and cur_iter % cfg.TRAIN.LOG_PERIOD == 0):
                logger.info("iter: {:4d}  {}  seg_iou_2d: {:.4f}  "
                            "seg_iou_3d: {:.4f}".format(
                                cur_iter, str(train_metric_logger),
                                metric_2d.global_avg, metric_3d.global_avg))

            if summary_writer is not None \
                    and cur_iter % cfg.TRAIN.SUMMARY_PERIOD == 0:
                keywords = ("loss", "acc", "iou", "ety")
                for name, meter in train_metric_logger.meters.items():
                    if any(k in name for k in keywords):
                        summary_writer.add_scalar("train/" + name, meter.avg,
                                                  global_step=cur_iter)

            if ((ckpt_period > 0 and cur_iter % ckpt_period == 0)
                    or cur_iter == max_iteration):
                if lead:
                    ck2d.save("model_2d_{:06d}".format(cur_iter),
                              iteration=cur_iter,
                              **{best_metric_name: best_metric["2d"]})
                    ck3d.save("model_3d_{:06d}".format(cur_iter),
                              iteration=cur_iter,
                              **{best_metric_name: best_metric["3d"]})
                sync()

            is_val = with_val and (cur_iter % val_period == 0
                                   or cur_iter == max_iteration)
            if is_val and lead:
                start_val = time.time()
                val_metric_logger.reset()
                eval_dict = validate(cfg, models, val_loader,
                                     val_metric_logger, logger)
                logger.info("Iteration[{}]-Val {}  total_time: {:.2f}s"
                            .format(cur_iter, val_metric_logger.summary_str,
                                    time.time() - start_val))
                for modality in ["2d", "3d", "xM"]:
                    name = cfg.VAL.METRIC + "_" + modality
                    if name not in val_metric_logger.meters:
                        continue
                    cur = val_metric_logger.meters[name].global_avg
                    if cur_iter >= max_iteration / 2 and (
                            best_metric[modality] is None
                            or best_metric[modality] < cur):
                        best_metric[modality] = cur
                        best_metric_iter[modality] = cur_iter
                        if modality in ("2d", "xM"):
                            ck2d.save("best_val_{}_2d".format(modality),
                                      tag=False)
                        if modality in ("3d", "xM"):
                            ck3d.save("best_val_{}_3d".format(modality),
                                      tag=False)
            if is_val:
                sync()  # the other ranks wait for rank 0's validation
            end = time.time()
    finally:
        _close(src_iter, trg_iter)
        if summary_writer is not None:
            summary_writer.close()

    for modality in ["2d", "3d", "xM"]:
        if best_metric[modality] is not None:
            logger.info("Best val-{}-{} = {:.2f} at iteration {}".format(
                modality.upper(), cfg.VAL.METRIC,
                best_metric[modality] * 100, best_metric_iter[modality]))

    if eval_dict and output_dir and lead:
        out = iou_to_excel(eval_dict,
                           osp.join(output_dir, "val_class_iou.xlsx"),
                           list(eval_dict.keys()))
        logger.info("Class-wise IoU saved to {}".format(out))
    return state, eval_dict


def require_cuda() -> None:
    """Raise unless a CUDA device is visible: the CLIs run on the card and
    have no CPU fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError("mopa_tpu_torch's command-line tools run on a "
                           "CUDA device, and torch.cuda.is_available() is "
                           "false (call train()/test_model() with "
                           "device=\"cpu\" to run on the CPU)")


def main_common(variant, description, default_cfg):
    """The train CLIs: parse the arguments, load the config, make the
    output directory and its log, check the losses the variant needs, and
    :func:`train` on the card. Under ``torchrun`` the process group is
    initialised first (``parallel.mesh.initialize_distributed``); rank 0
    makes the output directory and names it to the others, and only rank 0
    logs."""
    import logging

    from mopa_tpu_torch.common.logger import get_logger

    args = parse_args(description, default_cfg)
    require_cuda()
    mesh_mod.initialize_distributed()
    rank = dist.get_rank() if dist.is_initialized() else 0
    cfg = load_cfg(args)
    where = [None]
    if rank == 0:
        where = [prepare_output_dir(cfg, args)]
    if dist.is_initialized():
        dist.broadcast_object_list(where, src=0)
    output_dir, run_name, log_file = where[0]
    if rank == 0:
        logger = get_logger(output=log_file, abbrev_name=args.task)
    else:  # the other ranks log nothing (warnings reach stderr)
        logger = logging.getLogger("mopa_tpu_torch.rank{}".format(rank))
        logger.propagate = False
    logger.info("{} devices available".format(torch.cuda.device_count()))
    logger.info(args)
    logger.info("Loaded configuration file {:s}".format(args.config_file))

    assert cfg.MODEL_2D.DUAL_HEAD == cfg.MODEL_3D.DUAL_HEAD
    if variant != "baseline":
        # at least one loss on the target domain (reference :743-746)
        assert (cfg.TRAIN.XMUDA.lambda_xm_src > 0
                or cfg.TRAIN.XMUDA.lambda_xm_trg > 0
                or cfg.TRAIN.XMUDA.lambda_pl > 0
                or cfg.TRAIN.XMUDA.lambda_minent > 0)
    else:
        assert cfg.TRAIN.XMUDA.lambda_xm_trg == 0 \
            and cfg.TRAIN.XMUDA.lambda_pl == 0
    train(cfg, logger, output_dir, run_name, variant=variant)
