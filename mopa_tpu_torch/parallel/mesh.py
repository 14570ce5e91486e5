"""Data parallelism over ``torch.distributed`` (port of
``mopa_tpu/parallel/mesh.py``).

The JAX package trains data-parallel on a one-axis ``data`` device mesh: the
train state is replicated, each device takes one contiguous block of the
batch (``P("data")``), and the ``shard_map``-ed step averages gradients,
batch-norm running statistics and float metrics (``pmean``) and sums integer
metrics (``psum``). Here each process of a ``torch.distributed`` group plays
the part of one device of that mesh: :func:`make_data_mesh` describes the
group, :func:`shard_range` is ``P("data")``'s split of a batch (the loader
takes each rank's block so), and :func:`all_reduce` is the step's
collective, one flat bucket per call.

Two departures from the JAX package, both on purpose:

* :func:`initialize_distributed` lets a failed initialisation raise, where
  JAX's swallows every error and trains on one host.
* :func:`make_data_mesh` raises when ``TPU.DATA_PARALLEL`` asks for another
  number of ranks than the group has, where JAX quietly takes the first
  ``jax.devices()[:n]`` (or all of them when it asks for more).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclass
class DataMesh:
    """One rank's view of the data-parallel group: the group, its size,
    this process's rank in it and the group's backend. ``collectives`` and
    ``bytes`` count what :func:`all_reduce` has moved."""

    group: object
    size: int
    rank: int
    backend: str
    collectives: int = 0
    bytes: int = 0


def local_device() -> torch.device:
    """This process's card: ``cuda:LOCAL_RANK`` (``cuda:0`` without
    torchrun's environment)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def initialize_distributed() -> bool:
    """Initialise the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``;
    ``LOCAL_RANK`` picks the card): NCCL when CUDA is available, else gloo.
    A no-op, returning False, when that environment is absent or the group
    is already up; an initialisation that fails raises."""
    if dist.is_initialized():
        return False
    if not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def data_mesh(group=None) -> DataMesh:
    """The descriptor of ``group`` (the default group when None), whatever
    its size."""
    group = dist.group.WORLD if group is None else group
    return DataMesh(group=group, size=dist.get_world_size(group),
                    rank=dist.get_rank(group),
                    backend=str(dist.get_backend(group)))


def world_size() -> int:
    """The default group's size, 1 when no group is up."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_data_mesh(cfg=None, num_devices: int | None = None):
    """The data-parallel mesh a run trains on, or None for one process.

    ``num_devices`` (else ``cfg.TPU.DATA_PARALLEL``, 0 meaning the whole
    group) ranks; at most 1 gives None, as JAX's ``make_data_mesh`` does.
    Raises unless the default process group is up with exactly that many
    ranks."""
    if num_devices is None:
        num_devices = 0
        if cfg is not None and "TPU" in cfg:
            num_devices = int(cfg.TPU.DATA_PARALLEL)
        if num_devices == 0:
            num_devices = world_size()
    if num_devices <= 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(
            "TPU.DATA_PARALLEL {} needs a torch.distributed process group "
            "of {} ranks, and none is initialised (launch with torchrun "
            "--nproc_per_node {})".format(num_devices, num_devices,
                                          num_devices))
    if num_devices != world_size():
        raise RuntimeError(
            "TPU.DATA_PARALLEL {} does not match the process group's {} "
            "ranks (0 takes the whole group)".format(num_devices,
                                                     world_size()))
    return data_mesh()


def shard_range(n: int, mesh: DataMesh) -> tuple:
    """[start, stop) of rank ``mesh.rank``'s block of ``n`` items: the
    rank-th of ``mesh.size`` contiguous blocks, as ``P("data")`` splits a
    leading axis. ``n`` must divide evenly."""
    if n % mesh.size:
        raise ValueError("{} items do not split over {} ranks".format(
            n, mesh.size))
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def all_reduce(mesh: DataMesh, tensors: list, average: bool) -> None:
    """Sum (``average``: then divide by the group's size, JAX's ``pmean``)
    ``tensors`` across the group, in place, as one flat bucket: one
    collective whatever their number. The tensors share one dtype. The
    group's backend carries the tensors where they lie (gloo takes CUDA
    tensors too)."""
    if not tensors:
        return
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError("one bucket holds one dtype, got {}".format(dtypes))
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    if average:
        flat.div_(mesh.size)
    mesh.collectives += 1
    mesh.bytes += flat.numel() * flat.element_size()
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n

