"""The 3D nets of the benchmark, one module each, found by a
configuration's ``MODEL_3D.TYPE``: the module whose ``TYPE`` equals it.
Modules are found by walking this package, so a new net is a new file
here and no list is edited.

Each module provides:

- ``TYPE``: the program's name of the net (``MODEL_3D.TYPE``);
- ``build(sub, compute_dtype) -> nn.Module``: the reference's backbone,
  with the program's parameter names, from ``sub`` (the configuration's
  ``MODEL_3D.<TYPE>`` values). Its ``forward(feats, plan, nd, generator)``
  gives (N, width) point features; its attributes ``width`` and
  ``num_levels`` give their width and the voxel levels of its plan. Its
  modules that run GEMMs subclass ``net3d._Rounding`` and round the
  operands by ``self.r``, so that the control reaches them;
- ``convs(sub, dtype) -> list[counts.Conv]``: its sparse convs (the K1 /
  K2 launches among them);
- ``peak_s(sub, dtype, stats, n3d, n_valid, heads, classes) -> float``:
  the seconds of the net's model operations that are not its convs, the
  seg heads included, each at the peak of its dtype; ``stats`` holds each
  plan level's (voxels, submanifold pairs), ``n3d`` the points,
  ``n_valid`` those in a voxel, ``heads`` the seg heads, ``classes`` their
  outputs;
- ``small(sub) -> sub``: the values of the CPU tests' sizes.

It may also provide:

- ``work(sub, dtype, plan, stats) -> dict``: more least times or counts of
  a step, by names that start with the net's own prefix, for its readers
  (``metrics/*.py`` read them from ``ctx["work"]``, summed over the
  window's steps);
- ``check_hooks(program_net, readings) -> list``: hooks on the program's
  3D net for the first step, which keep on the host what they read in
  ``readings``. It is the one place where a net file touches the
  program's objects, and it reads them only: no net file imports the
  program (``test_reference_imports_nothing_of_the_program`` imports
  every module of this package to hold them to that);
- ``check_gaps(readings, net3d, feats, plan, nd, rounding) -> dict``:
  block-level numbers compared, whose limits stand in the cell's traffic
  file, as ``{"program": {name: gap}}``, and with a ``rounding`` (the
  control's dtype -> rounding map, else None) also ``"control"``.
  ``net3d`` is the reference's 3D net with the seeded weights in training
  mode, ``(feats, plan, nd)`` its input of the first step's source and
  target scans, made by the harness.
"""

from __future__ import annotations

import importlib
import pkgutil
from types import ModuleType


def modules() -> list:
    """Every module of this package, imported."""
    return [importlib.import_module(__name__ + "." + info.name)
            for info in pkgutil.iter_modules(__path__)]


def find(kind: str) -> ModuleType:
    """The module of this package whose ``TYPE`` is ``kind``."""
    for mod in modules():
        if getattr(mod, "TYPE", None) == kind:
            return mod
    raise ValueError(
        "no reference for the 3D net {0}: add benchmark/reference/nets3d/"
        "{1}.py with TYPE = {0!r} and the functions of "
        "benchmark/reference/nets3d/__init__.py".format(kind, kind.lower()))


def of(m3: dict) -> tuple:
    """(module, values) of a configuration's ``MODEL_3D`` values: the net
    its ``TYPE`` names and its ``MODEL_3D.<TYPE>`` values ({} if none)."""
    return find(m3["TYPE"]), dict(m3.get(m3["TYPE"], {}))
