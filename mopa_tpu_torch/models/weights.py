"""Weight bridge between flattened flax variables and the port's modules, both
ways (the layout of ``mopa_tpu/models/torch_compat.py::flatten_pytree``).

Input is the layout ``torch_compat.flatten_pytree`` gives: ``{"a.b.c":
numpy array}`` for the params and the batch stats of each net. The port's
modules carry the flax names, so the only renaming is ``.kernel`` ->
``.weight``; layouts convert as follows:

* conv ``(H, W, I, O)`` -> ``(O, I, H, W)``;
* ConvTranspose ``(H, W, I, O)`` -> ``(I, O, H, W)``, spatially flipped (flax
  applies the kernel without the flip torch uses);
* Dense ``(I, O)`` -> ``(O, I)``;
* SCN conv ``(K, Cin, Cout)`` and batch-norm ``scale/bias/mean/var`` unchanged.

A missing or extra name, or a shape that does not fit, raises.
:func:`to_flax` maps port tensors (parameters, their gradients or updates,
buffers) back to flax names and layouts, so a port state exports as the
reference's flattened variables and tests compare the two by name.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _convert(owner: nn.Module, arr: np.ndarray) -> np.ndarray:
    if isinstance(owner, nn.ConvTranspose2d):
        return np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
    if isinstance(owner, nn.Conv2d):
        return np.transpose(arr, (3, 2, 0, 1))
    if isinstance(owner, nn.Linear):
        return np.transpose(arr, (1, 0))
    raise TypeError("no kernel layout rule for {}".format(type(owner)))


def _to_flax_layout(owner: nn.Module, arr: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_convert`."""
    if isinstance(owner, nn.ConvTranspose2d):
        return np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1]
    if isinstance(owner, nn.Conv2d):
        return np.transpose(arr, (2, 3, 1, 0))
    if isinstance(owner, nn.Linear):
        return np.transpose(arr, (1, 0))
    raise TypeError("no kernel layout rule for {}".format(type(owner)))


def to_flax(module: nn.Module, tensors: dict) -> dict:
    """{port name: tensor} of ``module``'s parameters or buffers (or any
    tensors shaped like them, e.g. gradients) -> {flax name: float32 numpy
    array in the flax layout}. ``.weight`` of a conv or linear layer becomes
    ``.kernel``; other names are unchanged. The arrays are copies, never
    views of the tensors."""
    owners = dict(module.named_modules())
    out = {}
    for name, value in tensors.items():
        arr = np.array(value.detach().float().cpu())
        owner_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        owner = owners[owner_name]
        if leaf == "weight" and isinstance(
                owner, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            out[owner_name + ".kernel"] = np.ascontiguousarray(
                _to_flax_layout(owner, arr))
        else:
            out[name] = arr
    return out


def load_flax_state(module: nn.Module, flat_params: dict,
                    flat_stats: dict) -> None:
    """Load one net's flattened flax params and batch stats, strictly."""
    target = module.state_dict()
    owners = dict(module.named_modules())
    new = {}
    for name, value in list(flat_params.items()) + list(flat_stats.items()):
        arr = np.array(value, np.float32)
        key = name
        if name.endswith(".kernel"):
            key = name[:-len(".kernel")] + ".weight"
        if key not in target:
            raise KeyError("flax variable {} has no counterpart {} in {}"
                           .format(name, key, type(module).__name__))
        if name.endswith(".kernel"):
            arr = _convert(owners[key.rsplit(".", 1)[0]], arr)
        if key in new:
            raise KeyError("flax variable {} given twice".format(name))
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError("shape mismatch for {}: flax {} vs port {}"
                             .format(name, arr.shape, tuple(target[key].shape)))
        new[key] = torch.from_numpy(np.ascontiguousarray(arr))
    missing = sorted(set(target) - set(new))
    if missing:
        raise KeyError("no flax variable for {} in {}".format(
            missing, type(module).__name__))
    module.load_state_dict(new, strict=True)


def load_flax_params(net2d: nn.Module, net3d: nn.Module, flat_params_2d: dict,
                     flat_stats_2d: dict, flat_params_3d: dict,
                     flat_stats_3d: dict) -> None:
    """Load both nets (``Net2DSeg``, ``Net3DSeg``) from flattened flax
    variables, e.g. ``torch_compat.flatten_pytree(params_2d)``."""
    load_flax_state(net2d, flat_params_2d, flat_stats_2d)
    load_flax_state(net3d, flat_params_3d, flat_stats_3d)
