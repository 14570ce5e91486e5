"""Seeded weights, made on the device from the seed in one draw per net,
for the program and the reference alike.

The layout of each net is the reference's (:mod:`benchmark.reference`),
whose parameter names are the program's. Each weight is normal with the
variance of the program's own initialisers: 2 / (27 Cin) for a sparse conv
(K, Cin, Cout), 1 / fan_in for a dense conv, a transposed conv and a linear
layer; batch-norm scales are 1, biases 0.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference import net2d as r2d


def _std(mod: nn.Module, name: str, w: torch.Tensor) -> float:
    if isinstance(mod, r2d.ConvTranspose2d):
        return (w.shape[0] * w.shape[2] * w.shape[3]) ** -0.5
    if isinstance(mod, (nn.Conv2d, nn.Linear)):
        return w[0].numel() ** -0.5
    # a sparse conv weight (K, Cin, Cout)
    return (2.0 / (w.shape[0] * w.shape[1])) ** 0.5


def seeded_params(net: nn.Module, seed: int, device) -> dict:
    """name -> float32 tensor on ``device`` for every parameter of the
    reference net ``net``; the same seed gives the same tensors."""
    leaves, scales = [], []
    out = {}
    for mname, mod in net.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = (mname + "." if mname else "") + pname
            if p.dim() >= 2:
                leaves.append((name, tuple(p.shape)))
                scales.append(_std(mod, pname, p))
            elif pname == "scale" or (pname == "weight"
                                      and not isinstance(mod, nn.Linear)):
                out[name] = torch.ones(p.shape, device=device)
            else:
                out[name] = torch.zeros(p.shape, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(torch.Size(s).numel() for _, s in leaves)
    flat = torch.randn(total, generator=gen, device=device)
    i = 0
    for (name, shape), std in zip(leaves, scales):
        n = torch.Size(shape).numel()
        out[name] = flat[i:i + n].reshape(shape) * std
        i += n
    return out


def load_into(module: nn.Module, params: dict) -> None:
    """Copy ``params`` into the program's ``module`` by name; the names and
    shapes must match the module's parameters exactly."""
    own = dict(module.named_parameters())
    if set(own) != set(params):
        raise KeyError("the program's parameters differ from the "
                       "reference's: {}".format(
                           sorted(set(own) ^ set(params))[:8]))
    with torch.no_grad():
        for k, v in params.items():
            if own[k].shape != v.shape:
                raise ValueError("{}: {} against {}".format(
                    k, tuple(own[k].shape), tuple(v.shape)))
            own[k].copy_(v)
