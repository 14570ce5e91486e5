"""Operations and bytes of the work a step or a request needs, counted by
the benchmark from the shapes and the active voxels of its inputs, and the
table of peaks they are held against.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s on
bfloat16 operands, 495 TFLOP/s on float32 operands (the most the tensor
cores take on float32 inputs, whatever route a kernel takes), 3.35 TB/s of
HBM bandwidth.

Sparse convs count their active pairs: a submanifold conv's (voxel,
offset) pairs whose neighbour exists, a stride-2 conv's and a deconv's one
pair per fine voxel. A GEMM of M x K by K x N counts 2 M K N operations;
the backward of a layer counts twice its forward, and nothing recomputed
is counted.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}
HBM_BYTES_PER_S = 3.35e12
COL_BLOCK = 192   # widest output of one K1 / K2 launch
PLAN_BYTES = 72   # a voxel's wide-plan entries: 9 ranks + 9 codes, int32


@dataclass(frozen=True)
class Conv:
    """One sparse conv layer of a 3D net (each net's module lists its own,
    :mod:`benchmark.reference.nets3d`): ``kind`` "subm" (3x3x3),
    "down" (stride 2 onto ``level``), "up" (deconv from ``level`` + 1
    onto ``level``) or "one" (1x1); ``grad_in``: its input needs a
    gradient (the stem's does not)."""
    kind: str
    level: int
    cin: int
    cout: int
    dtype: torch.dtype
    grad_in: bool = True


def level_stats(plan) -> list:
    """(active voxels, submanifold pairs) of each level of a
    :class:`benchmark.reference.sparse3d.Plan`."""
    return [(int(lv.key.shape[0]), int((lv.nbr >= 0).sum()))
            for lv in plan.levels]


def _blocks(n: int) -> list:
    k = -(-n // COL_BLOCK)
    return [n // k + (1 if j < n % k else 0) for j in range(k)]


def conv_kernel_least_s(convs: list, stats: list, backward: bool) -> float:
    """Least time of every K1 launch (the submanifold convs' forward) and,
    with ``backward``, every K2 ``d_feats`` and ``d_w`` launch of one pass
    over ``stats``: per launch max(ops / peak of its dtype, bytes / HBM
    bandwidth), each input byte read once and each output byte written
    once; an output wider than :data:`COL_BLOCK` is one launch a block."""
    total = 0.0
    for c in convs:
        if c.kind != "subm":
            continue
        v, pairs = stats[c.level]
        e = torch.tensor([], dtype=c.dtype).element_size()
        peak = PEAK_FLOPS[c.dtype]

        def least(ops, nbytes):
            return max(ops / peak, nbytes / HBM_BYTES_PER_S)

        for cb in _blocks(c.cout):   # K1
            total += least(2 * pairs * c.cin * cb,
                           e * (v * c.cin + 27 * c.cin * cb + v * cb)
                           + PLAN_BYTES * v)
        if not backward:
            continue
        if c.grad_in:                # K2 d_feats, blocks of its Cin output
            for cb in _blocks(c.cin):
                total += least(2 * pairs * c.cout * cb,
                               e * (v * c.cout + 27 * c.cout * cb + v * cb)
                               + PLAN_BYTES * v)
        for cb in _blocks(c.cout):   # K2 d_w, float32 weight gradient
            total += least(2 * pairs * c.cin * cb,
                           e * (v * c.cin + v * cb) + 4 * 27 * c.cin * cb
                           + PLAN_BYTES * v)
    return total


def conv_peak_s(convs: list, stats: list) -> float:
    """Forward operations of the 3D net's convs over the peak of each
    one's dtype, in seconds."""
    total = 0.0
    for c in convs:
        v, pairs = stats[c.level]
        n = pairs if c.kind == "subm" else (
            stats[c.level - 1][0] if c.kind == "down" else v)
        total += 2 * n * c.cin * c.cout / PEAK_FLOPS[c.dtype]
    return total


def dense_peak_s(rows: int, cin: int, cout: int,
                 dtype=torch.float32) -> float:
    """A linear layer over ``rows`` rows, at the peak of ``dtype``."""
    return 2 * rows * cin * cout / PEAK_FLOPS[dtype]


def unet2d_flops(batch: int, height: int, width: int) -> int:
    """Forward operations of UNetResNet34's convs on ``batch`` images of
    height x width (padded to multiples of 16), from the shapes alone."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.net2d import UNetResNet34

    with torch.device("meta"):
        net = UNetResNet34(torch.float32).eval()
        img = torch.zeros((batch, height, width, 3))
    with FlopCounterMode(display=False) as fc:
        net(img)
    return int(fc.get_total_flops())
