"""P1 and P2: the row-gather probes as hand-written CUDA kernels, with their
plain PyTorch twins.

* P1 :func:`row_gather` replaces the Pallas TPU kernel
  ``tools/gather_micro.py::kern`` in ``pallas_gather``: a per-sample row
  gather ``out[s, i] = tab[s, idx[s, i]]``.
* P2 :func:`gather_gemm` replaces ``kern`` in ``fused``: the same gather of
  ``TAPS`` rows per output row, fused with the wide-column GEMM,
  ``out[s, v] = bf16(sum_j tab[s, idx[s, TAPS*v + j]] @ w[j*D:(j+1)*D])`` with
  float32 accumulation.

The kernels are ``mopa_tpu_torch/csrc/gather_micro.cu``, built with the
sparse-conv kernels by ``sparse_conv_cuda.build``, and count their launches
in ``sparse_conv_cuda.launches``. A wrapper takes its twin only for CPU
tensors; for CUDA tensors it launches the kernel or raises.

P2 runs on the tensor cores over :data:`TILE_M`-row output tiles. A tile
whose in-range ranks span fewer than :data:`WINDOW_ROWS` table rows reads
its rows from a shared-memory window of the table; any other tile gathers
them from global memory (the fallback). :func:`tile_windows` gives that
choice per tile on the host. The two constants mirror the kernel's
(``mopa_gather_gemm_tiling`` in the built library reports them).
"""

from __future__ import annotations

import torch

from mopa_tpu_torch.ops import sparse_conv_cuda
from mopa_tpu_torch.ops.sparse_conv_cuda import P1, P2

TAPS = 8      # wide columns per output row of P2
COUT = 16     # P2's output width (the kernel's register tile)
D_MAX = 128   # P2's widest table row
# P2's tiling (csrc kTileM, kWindowRows): output rows per tile, table rows a
# window holds.
TILE_M = 64
WINDOW_ROWS = 128


def tile_windows(idx: torch.Tensor, v: int,
                 window_rows: int = WINDOW_ROWS):
    """P2's per-tile choice on ranks ``idx`` (S, TAPS*M) into a V-row table.

    Returns (lo, hi, fits), each (S, ceil(M / TILE_M)): the least and the
    largest rank in [0, V) of the tile's TILE_M output rows (hi < lo when it
    has none), and whether the kernel reads the tile from a window of table
    rows [lo, hi] (hi - lo < window_rows, or no rank in range) rather than
    by the fallback."""
    s = idx.shape[0]
    m = idx.shape[1] // TAPS
    n = -(-m // TILE_M)
    r = idx.reshape(s, m * TAPS).long()
    pad = n * TILE_M * TAPS - m * TAPS
    r = torch.cat([r, r.new_full((s, pad), -1)], dim=1).reshape(s, n, -1)
    ok = (r >= 0) & (r < v)
    big = torch.iinfo(torch.int32).max
    lo = torch.where(ok, r, r.new_full((), big)).amin(dim=2)
    hi = torch.where(ok, r, r.new_full((), -big - 1)).amax(dim=2)
    fits = (hi < lo) | (hi - lo < window_rows)
    return lo, hi, fits


def row_gather_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1's twin: tab (S, V, D), idx (S, N) -> (S, N, D); a rank outside
    [0, V) reads a zero row, as the kernels do."""
    v = tab.shape[1]
    idx = idx.long()
    inside = (idx >= 0) & (idx < v)
    rows = torch.arange(tab.shape[0], device=tab.device)[:, None]
    out = tab[rows, torch.where(inside, idx, 0)]
    return torch.where(inside[..., None], out, torch.zeros_like(out))


def gather_gemm_plain(tab: torch.Tensor, idx: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """P2's twin: the gather, a float32 matmul, a cast to the table's dtype.
    tab (S, V, D), idx (S, TAPS*M), w (TAPS*D, Cout) -> (S, M, Cout)."""
    s, _, d = tab.shape
    a = row_gather_plain(tab, idx).reshape(s, -1, TAPS * d)
    return (a.float() @ w.float()).to(tab.dtype)


def _check(tab: torch.Tensor, idx: torch.Tensor, what: str) -> None:
    if tab.dtype != torch.bfloat16 or tab.dim() != 3 \
            or not tab.is_contiguous():
        raise ValueError("{} takes a contiguous (S, V, D) bfloat16 table"
                         .format(what))
    if tab.shape[2] % 8 or tab.data_ptr() % 16:
        raise ValueError("{}: table rows must be whole 16-byte vectors "
                         "(D a multiple of 8, 16-byte aligned), got D={}"
                         .format(what, tab.shape[2]))
    if idx.dtype != torch.int32 or idx.dim() != 2 \
            or idx.shape[0] != tab.shape[0] or not idx.is_contiguous() \
            or idx.device != tab.device:
        raise ValueError("{} takes contiguous int32 (S, N) ranks on {}"
                         .format(what, tab.device))


def row_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1 on a CUDA ``tab`` (S, V, D) bfloat16, D a multiple of 8, and int32
    ``idx`` (S, N) (a rank outside [0, V) reads a zero row); the twin on CPU
    tensors."""
    if not tab.is_cuda:
        return row_gather_plain(tab, idx)
    _check(tab, idx, "P1")
    s, v, d = tab.shape
    n = idx.shape[1]
    out = torch.empty((s, n, d), dtype=tab.dtype, device=tab.device)
    lib = sparse_conv_cuda.build()["gather"]
    with torch.cuda.device(tab.device):
        err = lib.mopa_row_gather(tab.data_ptr(), idx.data_ptr(),
                                  out.data_ptr(), s, v, n, d,
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("P1 launch failed with CUDA error {}".format(err))
    sparse_conv_cuda.launches[P1] += 1
    return out


def gather_gemm(tab: torch.Tensor, idx: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """P2 on a CUDA ``tab`` (S, V, D) bfloat16 (D a multiple of 8, at most
    128), int32 ``idx`` (S, TAPS*M) (16-byte aligned; a rank outside [0, V)
    reads a zero row) and a bfloat16 ``w`` (TAPS*D, 16); the twin on CPU
    tensors. Returns (S, M, 16) bfloat16."""
    if not tab.is_cuda:
        return gather_gemm_plain(tab, idx, w)
    _check(tab, idx, "P2")
    s, v, d = tab.shape
    if d > D_MAX or idx.shape[1] % TAPS or idx.data_ptr() % 16:
        raise ValueError("P2 takes D <= {} and 16-byte aligned ranks, N a "
                         "multiple of {}".format(D_MAX, TAPS))
    if w.shape != (TAPS * d, COUT) or w.dtype != torch.bfloat16 \
            or not w.is_contiguous() or w.device != tab.device \
            or w.data_ptr() % 16:
        raise ValueError("P2 takes a contiguous, 16-byte aligned ({}, {}) "
                         "bfloat16 weight on {}".format(TAPS * d, COUT,
                                                        tab.device))
    m = idx.shape[1] // TAPS
    out = torch.empty((s, m, COUT), dtype=tab.dtype, device=tab.device)
    lib = sparse_conv_cuda.build()["gather"]
    with torch.cuda.device(tab.device):
        err = lib.mopa_gather_gemm(tab.data_ptr(), idx.data_ptr(),
                                   w.data_ptr(), out.data_ptr(), s, v, m, d,
                                   COUT,
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("P2 launch failed with CUDA error {}".format(err))
    sparse_conv_cuda.launches[P2] += 1
    return out
