"""Colour jitter on numpy HWC float images (port of
``mopa_tpu/data/utils/image_aug.py``): torchvision's ``ColorJitter``
semantics, brightness, contrast and saturation factors drawn uniformly from
[max(0, 1 - v), 1 + v] and applied in a random order."""

import numpy as np

_GRAY = np.asarray([0.299, 0.587, 0.114], np.float32)


def _blend(img1, img2, factor):
    return factor * img1 + (1.0 - factor) * img2


def adjust_brightness(img, factor):
    return img * factor


def adjust_contrast(img, factor):
    mean = (img @ _GRAY).mean()
    return _blend(img, np.full_like(img, mean), factor)


def adjust_saturation(img, factor):
    gray = (img @ _GRAY)[..., None]
    return _blend(img, np.broadcast_to(gray, img.shape), factor)


def color_jitter(img, strengths, rng):
    """Jitter an (H, W, 3) float32 image in [0, 1] by ``strengths``
    (brightness, contrast, saturation) with the numpy Generator ``rng``;
    returns float32 clipped to [0, 1]."""
    ops = []
    names = (adjust_brightness, adjust_contrast, adjust_saturation)
    for fn, v in zip(names, strengths):
        if v and v > 0:
            lo, hi = max(0.0, 1.0 - v), 1.0 + v
            ops.append((fn, float(rng.uniform(lo, hi))))
    for k in rng.permutation(len(ops)):
        fn, f = ops[k]
        img = fn(img, f)
    return np.clip(img, 0.0, 1.0).astype(np.float32)
