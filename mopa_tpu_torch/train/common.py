"""Batches from the loader to the card (PyTorch port of
``mopa_tpu/train/common.py``'s ``device_batch``, ``device_prefetch`` and
``decode_batch``).

``device_batch`` ships a collated numpy batch in its compact wire dtypes,
without what the step can derive or never reads; ``device_prefetch`` does
that for a loader's batches ahead of the consumer, on a thread and, on a
card, on a side CUDA stream from pinned host memory. ``decode_batch`` (the
first stage of every step) widens a wire batch to compute dtypes on the
card and rebuilds what was left out.
"""

from __future__ import annotations

import numpy as np
import torch

from mopa_tpu_torch.common.run_ahead import run_ahead

_INT_KEYS = ("coords", "img_indices", "seg_label", "pseudo_label_2d",
             "pseudo_label_3d", "sam_mask", "ema_map", "ori_coords",
             "ori_img_indices", "hp_counts", "hp_inverse", "hp_ori_counts",
             "hp_ori_inverse", "cat_label", "hp_cat_counts", "hp_cat_inverse")

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
                 strip_keys=()) -> dict:
    """The arrays of a collated numpy batch that cross to the card, as the
    JAX package's ``device_batch`` picks them: no host-only ("_") key, no
    derivable ``batch_idx``/``ori_batch_idx``, none of ``strip_keys``, none
    of the EMA teacher's keys with ``strip_ema``; no voxel coordinates of a
    group whose host-built plan is shipped; no validity mask that its
    count rebuilds; and an all-ones feature column of at most 8 channels
    as the (B, C) float16 ``feats_ones`` / ``ori_feats_ones`` marker."""
    def keep(k):
        if k.startswith("_") or k in _DERIVED_KEYS or k in strip_keys:
            return False
        if strip_ema and is_ema_key(k):
            return False
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
                 strip_keys=()) -> dict:
    """Copy the :func:`_wire_arrays` of a collated numpy batch to
    ``device`` as tensors of the same dtypes. On a card each array goes
    through pinned host memory and a ``non_blocking`` copy on the current
    stream; on the CPU each is a plain copy."""
    device = torch.device(device)
    out = {}
    for k, v in _wire_arrays(batch, strip_ema, strip_keys).items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.clone()
    return out


def device_prefetch(iterator, device="cuda", strip_ema: bool = False,
                    strip_keys=()):
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
                    item = (device_batch(b, device, strip_ema, strip_keys),
                            None)
                else:
                    with torch.cuda.device(device), torch.cuda.stream(side):
                        t = device_batch(b, device, strip_ema, strip_keys)
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
    layout when absent. Keys starting with "_" stay on the host side and are
    dropped.
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
