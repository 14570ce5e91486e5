"""K1 and K2: the submanifold 3x3x3 conv forward and backward as hand-written
CUDA kernels.

* K1 replaces the Pallas TPU kernel ``mopa_tpu/ops/sparse_conv_pallas.py::
  _conv_kernel`` (launched by ``_fwd_call``);
* K2 replaces ``_bwd_kernel`` (launched by ``_bwd_call``) in two parts:
  ``d_feats`` runs K1's kernel in its mirror mode (the same windowed conv of
  the cotangent with the mirrored, transposed weight), and ``d_w`` is a
  reduction kernel of its own with a deterministic second pass.

Each has two routes, chosen by the dtype (:func:`route_for`):

* ``cuda-tensorcore`` for bfloat16, the train step's, the EMA teacher's and
  eval's: a wide-column gather by ``cp.async`` feeding ``mma.sync`` tensor-
  core GEMMs, the gather of the next stages in flight while the current one
  multiplies. K1 and ``d_feats`` read the forward weight in place
  (``d_feats`` as W'[k] = W[26-k]^T, through ``ldmatrix``'s transpose);
* ``cuda-3xtf32`` for float32, which the checking paths, the convergence
  run and SPVCNN's decoder use (float32 under a bfloat16 compute dtype, as
  in the JAX package): the same gather feeding TF32 ``mma.sync`` in 3xTF32
  (each operand split into a TF32 high and low part, three products
  summed), so float32 stays within 1e-4 of the plain twins (TF32 alone
  would not). K1 and ``d_feats`` take the forward weight in place too; the
  library first packs it into a scratch, transposed (``ldmatrix`` cannot
  transpose 32-bit elements) and already split
  (:func:`pack_weight_3xtf32` is that pack in PyTorch).

The sources are ``mopa_tpu_torch/csrc/submanifold_conv.cu`` (K1, K2
``d_feats``) and ``csrc/submanifold_conv_dw.cu`` (K2 ``d_w``), with the
tensor-core building blocks in ``csrc/tensor_core.cuh``; their headers say
what bounds each kernel on the card and how the design answers it.

Output widths above :data:`COUT_MAX` (SPVCNN's 256 and 384) run as column
blocks (:func:`column_blocks`): near-equal blocks of at most 192 columns,
each one launch of the same kernel on a packed slice of the weight (and, for
``d_w``, of the cotangent), stitched by one ``torch.cat``. A width of at most
192 is one launch.

Every CUDA source of the port (these two and ``csrc/gather_micro.cu``, the
gather probes of ``ops/gather.py``) is compiled for ``sm_90a`` by ``nvcc`` at
first use into ``mopa_tpu_torch/_build/`` by :func:`build` (named by the
hash of the source and the headers; the compilers run in parallel), loaded
with ``ctypes`` and launched on PyTorch's current stream.
Nothing here imports a CUDA toolchain at module import, and nothing falls
back: a missing ``nvcc``, a failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from mopa_tpu_torch.common import spans

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"conv": _PKG / "csrc" / "submanifold_conv.cu",
           "dw": _PKG / "csrc" / "submanifold_conv_dw.cu",
           "gather": _PKG / "csrc" / "gather_micro.cu"}
HEADERS = (_PKG / "csrc" / "tensor_core.cuh",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The widest output block one launch holds (csrc kCoutMax); wider outputs
# run as several blocks (column_blocks).
COUT_MAX = 192

K1 = "K1 submanifold_conv_fwd"
K2_DFEATS = "K2 submanifold_conv_bwd_dfeats"
K2_DW = "K2 submanifold_conv_bwd_dw"
P1 = "P1 row_gather"    # ops/gather.py
P2 = "P2 gather_gemm"   # ops/gather.py

TENSOR_CORE = "cuda-tensorcore"
TF32X3 = "cuda-3xtf32"

# The tensor-core kernels' tiling (csrc kTileM, kKC / kKV, the template
# instances): voxels per conv CTA, K rows per pipeline stage, and the
# 16-wide output blocks a warp may hold.
TILE_M = 128
K_STAGE = 32
NT_CHOICES = (1, 2, 3, 4, 6, 8, 12)
# d_w splits its voxel sum into ranges of about this many rows, at most
# this many ranges, so the summation order is a function of V alone.
ROWS_PER_RANGE = 2048
MAX_RANGES = 128

# Launch count of every kernel of the port; only the kernels' wrappers (below
# and in ops/gather.py) add to it, once per launch, so a caller can show
# which path a run went through. ``routes`` splits the conv kernels' counts
# by route.
launches = {K1: 0, K2_DFEATS: 0, K2_DW: 0, P1: 0, P2: 0}
routes = {name: {TENSOR_CORE: 0, TF32X3: 0}
          for name in (K1, K2_DFEATS, K2_DW)}
# the record of ``common.spans`` copies the counts at each step's start and
# end
spans.counter("launches", launches)

_libs: dict | None = None


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0
    for counts in routes.values():
        for route in counts:
            counts[route] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in HEADERS:
        h.update(header.read_bytes())
    return BUILD_DIR / "lib{}_{}.so".format(src.stem, h.hexdigest()[:16])


def build() -> dict:
    """Compile (once per source version) and load the kernel libraries.

    Missing libraries are compiled by parallel ``nvcc`` processes. The
    compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``<name>.log``."""
    global _libs
    if _libs is not None:
        return _libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name("{}.{}.tmp".format(so.name, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((so, tmp, cmd, proc))
    failed = []
    for so, tmp, cmd, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append("nvcc failed (rc {}): {}\n{}".format(
                proc.returncode, " ".join(cmd), err))
            continue
        so.with_suffix(".log").write_text(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    libs = {name: ctypes.CDLL(str(library_path(name))) for name in SOURCES}
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    for fn, args in (
            (libs["conv"].mopa_subm_conv_f32, [ptr] * 6 + [cint] * 6),
            (libs["conv"].mopa_subm_conv_tc, [ptr] * 5 + [cint] * 6),
            (libs["dw"].mopa_subm_conv_dw_f32, [ptr] * 6 + [cint] * 7),
            (libs["dw"].mopa_subm_conv_dw_tc, [ptr] * 6 + [cint] * 7),
            (libs["gather"].mopa_row_gather, [ptr] * 3 + [cint] * 4),
            (libs["gather"].mopa_gather_gemm, [ptr] * 4 + [cint] * 5)):
        fn.argtypes = args + [ptr]  # the stream last
        fn.restype = cint
    tiling = libs["gather"].mopa_gather_gemm_tiling
    tiling.argtypes = [ctypes.POINTER(cint)] * 2
    tiling.restype = None
    _libs = libs
    return libs


def route_for(dtype: torch.dtype) -> str:
    """The kernel route of a conv kernel's inputs: bfloat16 runs on the
    tensor cores in bfloat16, float32 in 3xTF32."""
    return TENSOR_CORE if dtype == torch.bfloat16 else TF32X3


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _nt(blocks16: int) -> int:
    """The smallest instantiated count of 16-wide blocks >= blocks16."""
    return next(nt for nt in NT_CHOICES if nt >= blocks16)


def conv_tile_shape(cin: int, cout: int) -> tuple[int, int]:
    """(KP, NP) of the tensor-core conv kernels (both routes) for Cin ->
    Cout: a column's K = 3*Cin rounded up to :data:`K_STAGE` (the kernel
    stages zeros past 3*Cin), and Cout rounded up to 16 * an instantiated
    block count (the kernel's register tile)."""
    return _cdiv(3 * cin, K_STAGE) * K_STAGE, 16 * _nt(_cdiv(cout, 16))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: on the bits, adding half
    a TF32 unit to the magnitude and clearing the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_weight_3xtf32(weight: torch.Tensor, mirror: bool, kp: int,
                       np_: int) -> torch.Tensor:
    """What the float32 conv launch's first kernel (``subm_conv_f32_pack``)
    writes into its scratch, in PyTorch: (9, 2, NP, KP) float32,
    ``pack[c][0][n][k] + pack[c][1][n][k]`` column c's B[k][n] split into
    its TF32 high part ``tf32_round(b)`` and low part
    ``tf32_round(b - high)``, zero past 3*Cin rows and Cout columns.

    B is transposed (n-major) so that the kernel's ``ldmatrix`` reads its
    fragments without a transpose. Forward (K1; ``weight`` (27, Cin, Cout)):
    B[t*Cin + ci][n] = weight[3c + t][ci][n]. Mirror (``d_feats``; the
    forward weight (27, Cout, Cin) of this launch's Cin -> Cout):
    B[t*Cin + ci][n] = weight[26 - 3c - t][n][ci]."""
    w = weight.flip(0) if mirror else weight.transpose(1, 2)
    _, cout, cin = w.shape  # (27, N, Cin): w[3c + t][n][ci] = B_c
    bt = w.reshape(9, 3, cout, cin).transpose(1, 2).reshape(9, cout, 3 * cin)
    pack = weight.new_zeros((9, 2, np_, kp))
    hi = tf32_round(bt)
    pack[:, 0, :cout, :3 * cin] = hi
    pack[:, 1, :cout, :3 * cin] = tf32_round(bt - hi)
    return pack


def tile_columns(ranks: torch.Tensor, sel: torch.Tensor,
                 v: int) -> torch.Tensor:
    """(ceil(V / TILE_M), 9) bool: the columns the tensor-core conv kernel
    stages for each tile of :data:`TILE_M` voxels, i.e. those in which some
    voxel of the tile has a row in [0, V) with a dz code < 3 (the kernel
    finds them itself; this is their count on the host)."""
    r = ranks.reshape(v, 9).long()
    codes = sel.reshape(v, 9)
    has = torch.zeros((v, 9), dtype=torch.bool, device=ranks.device)
    for j in range(3):
        has |= (((codes >> (2 * j)) & 3) != 3) & (r + j >= 0) & (r + j < v)
    n = _cdiv(v, TILE_M)
    has = torch.cat([has, has.new_zeros((n * TILE_M - v, 9))])
    return has.reshape(n, TILE_M, 9).any(dim=1)


def column_blocks(width: int) -> list[tuple[int, int]]:
    """[start, stop) of the output columns each launch computes for an output
    width: one block up to :data:`COUT_MAX`, else ceil(width / COUT_MAX)
    near-equal blocks, each but the last a multiple of 16 wide (256 -> 2 x
    128, 384 -> 2 x 192)."""
    n = _cdiv(width, COUT_MAX)
    step = width if n == 1 else min(COUT_MAX, _cdiv(_cdiv(width, n), 16) * 16)
    return [(c, min(c + step, width)) for c in range(0, width, step)]


def dw_ranges(v: int) -> tuple[int, int]:
    """(ranges, rows per range) that ``d_w`` splits V voxel rows into: about
    :data:`ROWS_PER_RANGE` rows each, at most :data:`MAX_RANGES`, rows a
    multiple of :data:`K_STAGE`; range r holds rows [r*rows, (r+1)*rows)."""
    n = min(MAX_RANGES, max(1, _cdiv(v, ROWS_PER_RANGE)))
    rows = _cdiv(_cdiv(max(v, 1), n), K_STAGE) * K_STAGE
    return max(1, _cdiv(v, rows)), rows


def dw_tiling(cin: int, cout: int) -> tuple[int, int]:
    """(wm, nt) of the tensor-core ``d_w`` CTA tile: wm warps of 16 channel
    rows (1, 2 or 4; fewer where Cin is narrow, or where 3*Cout would need
    more than 12 blocks a warp) by 8/wm warps of nt 16-wide blocks over
    3*Cout."""
    wm = 1 if cin <= 16 else 2 if cin <= 32 else 4
    while _cdiv(_cdiv(3 * cout, 16), 8 // wm) > NT_CHOICES[-1]:
        wm //= 2
    return wm, _nt(_cdiv(_cdiv(3 * cout, 16), 8 // wm))


def _check_plan(ranks: torch.Tensor, sel: torch.Tensor, v: int,
                device) -> None:
    for name, t in (("ranks", ranks), ("sel", sel)):
        if t.dtype != torch.int32 or t.shape != (v * 9,) \
                or not t.is_contiguous() or t.device != device:
            raise ValueError("{} must be contiguous int32 ({},) on {}".format(
                name, v * 9, device))


def _require_cuda(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError("{} takes CUDA tensors; got {}".format(what,
                                                               x.device))


def _check_rows(x: torch.Tensor, what: str) -> None:
    _require_cuda(x, what)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("{} takes float32 or bfloat16 rows, got {}".format(
            what, x.dtype))
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("{} takes contiguous (V, C) rows".format(what))


def _check_weight(weight: torch.Tensor, cin: int, cout: int,
                  like: torch.Tensor) -> None:
    if weight.shape != (27, cin, cout):
        raise ValueError("weight must be (27, {}, {}), got {}".format(
            cin, cout, tuple(weight.shape)))
    if weight.dtype != like.dtype or weight.device != like.device \
            or not weight.is_contiguous():
        raise ValueError("weight must be contiguous {} on {}, got {} on {}"
                         .format(like.dtype, like.device, weight.dtype,
                                 weight.device))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(kernel: str, route: str, fn, device, *args) -> None:
    """Call the library function ``fn`` with tensors passed as pointers and
    the current stream last; raise on a CUDA error, else count the launch."""
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(device):
        err = fn(*c_args, _stream(device))
    if err != 0:
        raise RuntimeError("{} ({}) launch failed with CUDA error {}".format(
            kernel, route, err))
    launches[kernel] += 1
    routes[kernel][route] += 1


def _conv_block(kernel: str, rows: torch.Tensor, ranks: torch.Tensor,
                sel: torch.Tensor, weight: torch.Tensor, out: torch.Tensor,
                mirror: bool) -> None:
    """One launch of the conv kernel writing all of ``out`` (V, width)."""
    v, cin = rows.shape
    width = out.shape[1]
    route = route_for(rows.dtype)
    lib = build()["conv"]
    kp, np_ = conv_tile_shape(cin, width)
    if route == TENSOR_CORE:
        _launch(kernel, route, lib.mopa_subm_conv_tc, rows.device, rows,
                ranks, sel, weight, out, v, cin, width, int(mirror), kp, np_)
    else:
        # the weight's split pack, written by the launch's first kernel
        pack = torch.empty((9, 2, np_, kp), dtype=torch.float32,
                           device=rows.device)
        _launch(kernel, route, lib.mopa_subm_conv_f32, rows.device, rows,
                ranks, sel, weight, pack, out, v, cin, width, int(mirror),
                kp, np_)


def _conv(kernel: str, rows: torch.Tensor, ranks: torch.Tensor,
          sel: torch.Tensor, weight: torch.Tensor, out_width: int,
          mirror: bool) -> torch.Tensor:
    """K1 (mirror False, weight (27, Cin, Cout)) or K2 ``d_feats`` (mirror
    True, the forward weight (27, Cout_in, Cin_in) read as W') on ``rows``
    (V, Cin) -> (V, out_width): one launch per :func:`column_blocks` block
    on the block's columns of the weight (the weight itself when there is
    one block: a full-width slice is contiguous, so nothing is copied)."""
    v = rows.shape[0]
    outs = []
    for c0, c1 in column_blocks(out_width):
        w = weight[:, c0:c1] if mirror else weight[:, :, c0:c1]
        out = torch.empty((v, c1 - c0), dtype=rows.dtype, device=rows.device)
        if v:
            _conv_block(kernel, rows, ranks, sel, w.contiguous(), out, mirror)
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def submanifold_conv_wide_cuda(feats: torch.Tensor, ranks: torch.Tensor,
                               sel: torch.Tensor,
                               weight: torch.Tensor) -> torch.Tensor:
    """K1 over a flat wide-column plan (see ``sparse_conv.WidePlan``).

    feats (V, Cin) float32 or bfloat16, contiguous, on a CUDA device;
    ranks/sel (V*9,) int32 on the same device; weight (27, Cin, Cout), any
    Cout >= 1 (:func:`column_blocks`), contiguous, in the feature dtype on
    the same device (the conv's autograd Function casts the float32
    parameter before it calls this). Returns (V, Cout) in the feature dtype, accumulated in float32."""
    _check_rows(feats, "K1")
    v, cin = feats.shape
    if weight.dim() != 3 or weight.shape[0] != 27 or weight.shape[1] != cin:
        raise ValueError("weight must be (27, {}, Cout), got {}".format(
            cin, tuple(weight.shape)))
    cout = weight.shape[2]
    if cout < 1:
        raise ValueError("K1 needs Cout >= 1, got {}".format(cout))
    _check_weight(weight, cin, cout, feats)
    _check_plan(ranks, sel, v, feats.device)
    return _conv(K1, feats, ranks, sel, weight, cout, mirror=False)


def submanifold_conv_wide_bwd_dfeats_cuda(g: torch.Tensor,
                                          ranks: torch.Tensor,
                                          sel: torch.Tensor,
                                          weight: torch.Tensor
                                          ) -> torch.Tensor:
    """K2's ``d_feats``: the windowed conv of the cotangent ``g`` (V, Cout)
    with ``weight[::-1].transpose(1, 2)``, from the FORWARD weight (27, Cin,
    Cout) (any Cin >= 1, :func:`column_blocks`), in the cotangent's dtype. Returns (V, Cin) in that
    dtype, accumulated in float32."""
    _check_rows(g, "K2 d_feats")
    v, cout = g.shape
    if weight.dim() != 3 or weight.shape[0] != 27 or weight.shape[2] != cout:
        raise ValueError("weight must be (27, Cin, {}), got {}".format(
            cout, tuple(weight.shape)))
    cin = weight.shape[1]
    if cin < 1:
        raise ValueError("K2 d_feats needs Cin >= 1, got {}".format(cin))
    _check_weight(weight, cin, cout, g)
    _check_plan(ranks, sel, v, g.device)
    return _conv(K2_DFEATS, g, ranks, sel, weight, cin, mirror=True)


def submanifold_conv_wide_bwd_dw_cuda(g: torch.Tensor, feats: torch.Tensor,
                                      ranks: torch.Tensor,
                                      sel: torch.Tensor) -> torch.Tensor:
    """K2's ``d_w`` (27, Cin, Cout) float32 from the cotangent ``g`` (V, Cout)
    and the forward input ``feats`` (V, Cin), both in one dtype (float32 or
    bfloat16) on a CUDA device, any Cout >= 1. Reduced without atomics over
    the voxel ranges of :func:`dw_ranges`: the same inputs give the same
    bits. One launch per :func:`column_blocks` block of Cout, on the block's
    cotangent columns (``g`` itself when there is one block)."""
    _check_rows(g, "K2 d_w")
    _check_rows(feats, "K2 d_w")
    v, cout = g.shape
    if feats.shape[0] != v or feats.dtype != g.dtype \
            or feats.device != g.device:
        raise ValueError("feats must be ({}, Cin) {} on {}".format(
            v, g.dtype, g.device))
    if cout < 1:
        raise ValueError("K2 d_w needs Cout >= 1, got {}".format(cout))
    _check_plan(ranks, sel, v, g.device)
    outs = [_dw_block(g[:, c0:c1].contiguous(), feats, ranks, sel)
            for c0, c1 in column_blocks(cout)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


def _dw_block(g: torch.Tensor, feats: torch.Tensor, ranks: torch.Tensor,
              sel: torch.Tensor) -> torch.Tensor:
    """One launch of the ``d_w`` kernel: (27, Cin, g's width) float32."""
    v, cout = g.shape
    cin = feats.shape[1]
    ranges, rows = dw_ranges(v)
    # per-range column blocks (ranges, 9, Cin, 3*Cout), both routes
    partial = torch.empty((ranges, 9, cin, 3 * cout), dtype=torch.float32,
                          device=g.device)
    out = torch.empty((27, cin, cout), dtype=torch.float32, device=g.device)
    route = route_for(g.dtype)
    lib = build()["dw"]
    fn = lib.mopa_subm_conv_dw_tc if route == TENSOR_CORE \
        else lib.mopa_subm_conv_dw_f32
    _launch(K2_DW, route, fn, g.device, feats, g, ranks, sel, partial, out,
            v, cin, cout, ranges, rows, *dw_tiling(cin, cout))
    return out
