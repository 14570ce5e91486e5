"""Turbo colormap interpolation (port of
``mopa_tpu/data/utils/turbo_cmap.py``; reference
``mopa/data/utils/turbo_cmap.py``).

Uses matplotlib's built-in Google turbo LUT rather than vendoring the table.
A tensor input is copied to the host first.
"""

import numpy as np
import torch


def _lut(n=256):
    import matplotlib

    return matplotlib.colormaps["turbo"].resampled(n)(
        np.linspace(0, 1, n))[:, :3]


def interpolate(x, low=None, high=None):
    """Map scalar array x (any range) to turbo RGB in [0, 1]."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float64)
    low = np.min(x) if low is None else low
    high = np.max(x) if high is None else high
    t = np.clip((x - low) / max(high - low, 1e-12), 0.0, 1.0)
    lut = _lut()
    idx = t * (len(lut) - 1)
    i0 = np.floor(idx).astype(int)
    i1 = np.minimum(i0 + 1, len(lut) - 1)
    frac = (idx - i0)[..., None]
    return (1 - frac) * lut[i0] + frac * lut[i1]
