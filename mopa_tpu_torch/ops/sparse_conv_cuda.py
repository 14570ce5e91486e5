"""K1 and K2: the submanifold 3x3x3 conv forward and backward as hand-written
CUDA kernels.

* K1 replaces the Pallas TPU kernel ``mopa_tpu/ops/sparse_conv_pallas.py::
  _conv_kernel`` (launched by ``_fwd_call``);
* K2 replaces ``_bwd_kernel`` (launched by ``_bwd_call``) in two parts:
  ``d_feats`` runs K1's kernel in its mirror mode (the same windowed conv of
  the cotangent with the mirrored, transposed weight), and ``d_w`` is a
  reduction kernel of its own with a deterministic second pass.

The sources are ``mopa_tpu_torch/csrc/submanifold_conv.cu`` (K1, K2
``d_feats``) and ``csrc/submanifold_conv_dw.cu`` (K2 ``d_w``); their headers
say what bounds each kernel on the card and how the design answers it.

Every CUDA source of the port (these two and ``csrc/gather_micro.cu``, the
gather probes of ``ops/gather.py``) is compiled for ``sm_90a`` by ``nvcc`` at
first use into ``mopa_tpu_torch/_build/`` by :func:`build` (named by the
source's hash; the compilers run in parallel), loaded with ``ctypes`` and
launched on PyTorch's current stream.
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

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"conv": _PKG / "csrc" / "submanifold_conv.cu",
           "dw": _PKG / "csrc" / "submanifold_conv_dw.cu",
           "gather": _PKG / "csrc" / "gather_micro.cu"}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
COUT_MAX = 192  # the register tiles' widest output width (csrc kCoutMax)

K1 = "K1 submanifold_conv_fwd"
K2_DFEATS = "K2 submanifold_conv_bwd_dfeats"
K2_DW = "K2 submanifold_conv_bwd_dw"
P1 = "P1 row_gather"    # ops/gather.py
P2 = "P2 gather_gemm"   # ops/gather.py

# Launch count of every kernel of the port; only the kernels' wrappers (below
# and in ops/gather.py) add to it, once per launch, so a caller can show
# which path a run went through.
launches = {K1: 0, K2_DFEATS: 0, K2_DW: 0, P1: 0, P2: 0}

_libs: dict | None = None


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


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
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / "lib{}_{}.so".format(src.stem, tag)


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
    for fn in (libs["conv"].mopa_subm_conv_fwd,
               libs["conv"].mopa_subm_conv_bwd_dfeats):
        fn.argtypes = [ptr] * 5 + [cint] * 4 + [ptr]
        fn.restype = cint
    libs["dw"].mopa_subm_conv_bwd_dw.argtypes = [ptr] * 6 + [cint] * 4 \
        + [ptr]
    libs["dw"].mopa_subm_conv_bwd_dw.restype = cint
    libs["dw"].mopa_subm_conv_dw_ranges.argtypes = [cint]
    libs["dw"].mopa_subm_conv_dw_ranges.restype = cint
    libs["gather"].mopa_row_gather.argtypes = [ptr] * 3 + [cint] * 4 + [ptr]
    libs["gather"].mopa_gather_gemm.argtypes = [ptr] * 4 + [cint] * 5 + [ptr]
    for fn in (libs["gather"].mopa_row_gather,
               libs["gather"].mopa_gather_gemm):
        fn.restype = cint
    _libs = libs
    return libs


def _check_plan(ranks: torch.Tensor, sel: torch.Tensor, v: int,
                device) -> None:
    for name, t in (("ranks", ranks), ("sel", sel)):
        if t.dtype != torch.int32 or t.shape != (v * 9,) \
                or not t.is_contiguous() or t.device != device:
            raise ValueError("{} must be contiguous int32 ({},) on {}".format(
                name, v * 9, device))


def _check_rows(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError("{} takes CUDA tensors; got {}".format(what,
                                                               x.device))
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


def submanifold_conv_wide_cuda(feats: torch.Tensor, ranks: torch.Tensor,
                               sel: torch.Tensor,
                               weight: torch.Tensor) -> torch.Tensor:
    """K1 over a flat wide-column plan (see ``sparse_conv.WidePlan``).

    feats (V, Cin) float32 or bfloat16, contiguous, on a CUDA device;
    ranks/sel (V*9,) int32 on the same device; weight (27, Cin, Cout) with
    Cout <= 192, contiguous, in the feature dtype on the same device (the
    conv's autograd Function casts the float32 parameter before it calls
    this). Returns (V, Cout) in the feature dtype, accumulated in float32."""
    _check_rows(feats, "K1")
    v, cin = feats.shape
    if weight.dim() != 3 or weight.shape[0] != 27 or weight.shape[1] != cin:
        raise ValueError("weight must be (27, {}, Cout), got {}".format(
            cin, tuple(weight.shape)))
    cout = weight.shape[2]
    if not 1 <= cout <= COUT_MAX:
        raise ValueError("K1 supports 1 <= Cout <= {}, got {}".format(
            COUT_MAX, cout))
    _check_weight(weight, cin, cout, feats)
    _check_plan(ranks, sel, v, feats.device)
    out = torch.empty((v, cout), dtype=feats.dtype, device=feats.device)
    if v == 0:
        return out
    lib = build()["conv"]
    with torch.cuda.device(feats.device):
        err = lib.mopa_subm_conv_fwd(
            feats.data_ptr(), ranks.data_ptr(), sel.data_ptr(),
            weight.data_ptr(), out.data_ptr(), v, cin, cout,
            int(feats.dtype == torch.bfloat16), _stream(feats.device))
    if err != 0:
        raise RuntimeError("K1 launch failed with CUDA error {}".format(err))
    launches[K1] += 1
    return out


def submanifold_conv_wide_bwd_dfeats_cuda(g: torch.Tensor,
                                          ranks: torch.Tensor,
                                          sel: torch.Tensor,
                                          weight: torch.Tensor
                                          ) -> torch.Tensor:
    """K2's ``d_feats``: the windowed conv of the cotangent ``g`` (V, Cout)
    with ``weight[::-1].transpose(1, 2)``, read in place from the FORWARD
    weight (27, Cin, Cout) (Cin <= 192), in the cotangent's dtype. Returns
    (V, Cin) in that dtype, accumulated in float32."""
    _check_rows(g, "K2 d_feats")
    v, cout = g.shape
    if weight.dim() != 3 or weight.shape[0] != 27 or weight.shape[2] != cout:
        raise ValueError("weight must be (27, Cin, {}), got {}".format(
            cout, tuple(weight.shape)))
    cin = weight.shape[1]
    if not 1 <= cin <= COUT_MAX:
        raise ValueError("K2 d_feats supports 1 <= Cin <= {}, got {}".format(
            COUT_MAX, cin))
    _check_weight(weight, cin, cout, g)
    _check_plan(ranks, sel, v, g.device)
    out = torch.empty((v, cin), dtype=g.dtype, device=g.device)
    if v == 0:
        return out
    lib = build()["conv"]
    with torch.cuda.device(g.device):
        err = lib.mopa_subm_conv_bwd_dfeats(
            g.data_ptr(), ranks.data_ptr(), sel.data_ptr(), weight.data_ptr(),
            out.data_ptr(), v, cin, cout, int(g.dtype == torch.bfloat16),
            _stream(g.device))
    if err != 0:
        raise RuntimeError("K2 d_feats launch failed with CUDA error {}"
                           .format(err))
    launches[K2_DFEATS] += 1
    return out


def submanifold_conv_wide_bwd_dw_cuda(g: torch.Tensor, feats: torch.Tensor,
                                      ranks: torch.Tensor,
                                      sel: torch.Tensor) -> torch.Tensor:
    """K2's ``d_w`` (27, Cin, Cout) float32 from the cotangent ``g`` (V, Cout)
    and the forward input ``feats`` (V, Cin), both in one dtype (float32 or
    bfloat16) on a CUDA device, Cout <= 192. Reduced without atomics: the
    same inputs give the same bits."""
    _check_rows(g, "K2 d_w")
    _check_rows(feats, "K2 d_w")
    v, cout = g.shape
    cin = feats.shape[1]
    if feats.shape[0] != v or feats.dtype != g.dtype \
            or feats.device != g.device:
        raise ValueError("feats must be ({}, Cin) {} on {}".format(
            v, g.dtype, g.device))
    if not 1 <= cout <= COUT_MAX:
        raise ValueError("K2 d_w supports 1 <= Cout <= {}, got {}".format(
            COUT_MAX, cout))
    _check_plan(ranks, sel, v, g.device)
    libs = build()
    ranges = libs["dw"].mopa_subm_conv_dw_ranges(v)
    partial = torch.empty((ranges, 27, cin, cout), dtype=torch.float32,
                          device=g.device)
    out = torch.empty((27, cin, cout), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = libs["dw"].mopa_subm_conv_bwd_dw(
            feats.data_ptr(), g.data_ptr(), ranks.data_ptr(), sel.data_ptr(),
            partial.data_ptr(), out.data_ptr(), v, cin, cout,
            int(g.dtype == torch.bfloat16), _stream(g.device))
    if err != 0:
        raise RuntimeError("K2 d_w launch failed with CUDA error {}".format(
            err))
    launches[K2_DW] += 1
    return out
