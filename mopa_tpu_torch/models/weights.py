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
* SCN conv ``(K, Cin, Cout)`` and batch-norm ``scale/bias/mean/var`` unchanged;
* layer norm: the port's ``LayerNorm`` (``models/sam.py``) keeps flax's
  ``scale`` / ``bias`` names, so they cross unchanged;
* raw parameters (SAM's channels-last ``pos_embed``, ``rel_pos_h/w``,
  ``iou_token``, ``mask_tokens``, ``pe_gaussian`` and the prompt
  embeddings) unchanged.

flax names that hold dots (``mlp.lin1`` in a SAM decoder block,
``layers.0``, ``hyper_mlps.0.layers.2``) flatten to the same string as the
port's nested modules and ``nn.ModuleList`` indices, so they need no rule.
A missing or extra name, or a shape that does not fit, raises.
:func:`to_flax` maps port tensors (parameters, their gradients or updates,
optimizer moments, buffers) back to flax names and layouts, and
:func:`from_flax` maps them forth, so a port state exports as the
reference's flattened variables (its checkpoints among them) and loads
from them, and tests compare the two by name.

:func:`load_resnet34_file` loads the ImageNet ResNet34 encoder of the 2D net
from a torchvision ``.pth`` or from the JAX package's converted ``.npz``.
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


def from_flax(module: nn.Module, flat: dict, target: dict) -> dict:
    """{flax name: array} -> {port name: float32 tensor in the port's
    layout} for the names of ``target`` ({port name: tensor} of ``module``'s
    parameters or buffers, or tensors shaped like them, e.g. optimizer
    moments). The inverse of :func:`to_flax`. A flax name without a
    counterpart in ``target``, a name of ``target`` left without a flax
    variable, or a shape that does not fit raises."""
    owners = dict(module.named_modules())
    out = {}
    for name, value in flat.items():
        arr = np.array(value, np.float32)
        key = name
        if name.endswith(".kernel"):
            key = name[:-len(".kernel")] + ".weight"
        if key not in target:
            raise KeyError("flax variable {} has no counterpart {} in {}"
                           .format(name, key, type(module).__name__))
        if name.endswith(".kernel"):
            arr = _convert(owners[key.rsplit(".", 1)[0]], arr)
        if key in out:
            raise KeyError("flax variable {} given twice".format(name))
        if tuple(arr.shape) != tuple(target[key].shape):
            raise ValueError("shape mismatch for {}: flax {} vs port {}"
                             .format(name, arr.shape, tuple(target[key].shape)))
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError("no flax variable for {} in {}".format(
            missing, type(module).__name__))
    return out


def load_flax_state(module: nn.Module, flat_params: dict,
                    flat_stats: dict) -> None:
    """Load one net's flattened flax params and batch stats, strictly."""
    both = set(flat_params) & set(flat_stats)
    if both:
        raise KeyError("flax variables {} given twice".format(sorted(both)))
    module.load_state_dict(from_flax(module, {**flat_params, **flat_stats},
                                     module.state_dict()), strict=True)


def load_flax_params(net2d: nn.Module, net3d: nn.Module, flat_params_2d: dict,
                     flat_stats_2d: dict, flat_params_3d: dict,
                     flat_stats_3d: dict) -> None:
    """Load both nets (``Net2DSeg``, ``Net3DSeg``) from flattened flax
    variables, e.g. ``torch_compat.flatten_pytree(params_2d)``."""
    load_flax_state(net2d, flat_params_2d, flat_stats_2d)
    load_flax_state(net3d, flat_params_3d, flat_stats_3d)


# ResNet34's residual blocks per stage (torchvision's ``layer1`` ..
# ``layer4``).
RESNET34_BLOCKS = {"layer1": 3, "layer2": 4, "layer3": 6, "layer4": 3}


def load_resnet34_encoder(state_dict: dict, prefix: str = "net_2d") -> dict:
    """A torchvision ``resnet34`` state dict -> {port name: float32 tensor}
    of the UNetResNet34 encoder under ``prefix`` (the JAX package's
    ``torch_compat.load_resnet34_encoder`` name map). Bare torchvision names
    and the same under ``module.`` / ``net_2d.`` are accepted; ``fc.*``
    and ``num_batches_tracked`` are not read. Convolutions keep their
    torchvision layout, which is the port's; batch norm's ``weight`` /
    ``bias`` / ``running_mean`` / ``running_var`` become ``scale`` /
    ``bias`` / ``mean`` / ``var``. A missing name raises ``KeyError``."""
    sd = {}
    for k, v in state_dict.items():
        k = k.replace("module.", "")
        if k.startswith("net_2d."):
            k = k[len("net_2d."):]
        sd[k] = v
    out = {}

    def conv(src, dst):
        out[dst + ".weight"] = sd[src + ".weight"]

    def bn(src, dst):
        for s, d in (("weight", "scale"), ("bias", "bias"),
                     ("running_mean", "mean"), ("running_var", "var")):
            out[dst + "." + d] = sd[src + "." + s]

    conv("conv1", prefix + ".conv1")
    bn("bn1", prefix + ".bn1")
    for layer, n_blocks in RESNET34_BLOCKS.items():
        for b in range(n_blocks):
            src = "{}.{}".format(layer, b)
            dst = "{}.{}.block{}".format(prefix, layer, b)
            conv(src + ".conv1", dst + ".conv1")
            bn(src + ".bn1", dst + ".bn1")
            conv(src + ".conv2", dst + ".conv2")
            bn(src + ".bn2", dst + ".bn2")
            if src + ".downsample.0.weight" in sd:
                conv(src + ".downsample.0", dst + ".downsample_conv")
                bn(src + ".downsample.1", dst + ".downsample_bn")
    return {k: torch.as_tensor(v, dtype=torch.float32)
            for k, v in out.items()}


def load_resnet34_file(net2d: nn.Module, path: str) -> None:
    """Load the ImageNet ResNet34 encoder into ``net2d`` (a ``Net2DSeg``) in
    place; its decoder and heads keep their weights. ``path`` is a
    torchvision ``.pth`` state dict (read with ``torch.load`` on the CPU),
    or a ``.npz`` of flax names (``params.<name>`` / ``batch_stats.<name>``,
    the JAX package's ``tools/convert_resnet34.py``) read through
    :func:`from_flax`. A name the net does not have, or a shape that does
    not fit, raises."""
    state = net2d.state_dict()
    if path.endswith(".npz"):
        with np.load(path) as z:
            flat = {k.split(".", 1)[1]: z[k] for k in z.files
                    if k.startswith(("params.", "batch_stats."))}
        keys = [n[:-len(".kernel")] + ".weight" if n.endswith(".kernel")
                else n for n in flat]
        loaded = from_flax(net2d, flat, {k: state[k] for k in keys})
    else:
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        loaded = load_resnet34_encoder(sd)
    with torch.no_grad():
        for k, v in loaded.items():
            if k not in state:
                raise KeyError("the 2D net has no {}".format(k))
            if tuple(v.shape) != tuple(state[k].shape):
                raise ValueError("shape mismatch for {}: file {} vs net {}"
                                 .format(k, tuple(v.shape),
                                         tuple(state[k].shape)))
            state[k].copy_(v)
