"""K1: the submanifold 3x3x3 conv forward as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``mopa_tpu/ops/sparse_conv_pallas.py::
_conv_kernel`` (launched by ``_fwd_call``). The source is
``mopa_tpu_torch/csrc/submanifold_conv.cu``; its header says what bounds the
kernel on the card and how the design answers it.

The kernel is compiled for ``sm_90a`` by ``nvcc`` at first use into
``mopa_tpu_torch/_build/`` (named by the source's hash), loaded with
``ctypes`` and launched on PyTorch's current stream. Nothing here imports a
CUDA toolchain at module import, and nothing falls back: a missing ``nvcc``,
a failed build or a failed launch raises.
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
SOURCE = _PKG / "csrc" / "submanifold_conv.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
COUT_MAX = 128  # the register tile's widest Cout (csrc kCoutMax)

# Launch count of the kernel; only the wrapper below adds to it, once per
# launch, so a caller can show which path a run went through.
launches = {"K1 submanifold_conv_fwd": 0}

_lib = None


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


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / "libmopa_subm_conv_{}.so".format(tag)


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``<name>.log``."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name("{}.{}.tmp".format(so.name, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc failed (rc {}): {}\n{}".format(
                res.returncode, " ".join(cmd), res.stderr))
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.mopa_subm_conv_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def submanifold_conv_wide_cuda(feats: torch.Tensor, ranks: torch.Tensor,
                               sel: torch.Tensor,
                               weight: torch.Tensor) -> torch.Tensor:
    """K1 over a flat wide-column plan (see ``sparse_conv.WidePlan``).

    feats (V, Cin) float32 or bfloat16, contiguous, on a CUDA device;
    ranks/sel (V*9,) int32 on the same device; weight (27, Cin, Cout) with
    Cout <= 128, contiguous, in the feature dtype on the same device (the
    3D net holds its conv weights in the compute dtype). Returns (V, Cout)
    in the feature dtype, accumulated in float32."""
    if not feats.is_cuda:
        raise ValueError("K1 takes CUDA tensors; got {}".format(feats.device))
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("K1 takes float32 or bfloat16 features, got {}"
                        .format(feats.dtype))
    if feats.dim() != 2 or not feats.is_contiguous():
        raise ValueError("feats must be a contiguous (V, Cin) tensor")
    v, cin = feats.shape
    if weight.dim() != 3 or weight.shape[0] != 27 or weight.shape[1] != cin:
        raise ValueError("weight must be (27, {}, Cout), got {}".format(
            cin, tuple(weight.shape)))
    cout = weight.shape[2]
    if not 1 <= cout <= COUT_MAX:
        raise ValueError("K1 supports 1 <= Cout <= {}, got {}".format(
            COUT_MAX, cout))
    for name, t in (("ranks", ranks), ("sel", sel)):
        if t.dtype != torch.int32 or t.shape != (v * 9,) \
                or not t.is_contiguous() or t.device != feats.device:
            raise ValueError("{} must be contiguous int32 ({},) on {}".format(
                name, v * 9, feats.device))
    if weight.dtype != feats.dtype or weight.device != feats.device \
            or not weight.is_contiguous():
        raise ValueError("weight must be contiguous {} on {}, got {} on {}"
                         .format(feats.dtype, feats.device, weight.dtype,
                                 weight.device))
    out = torch.empty((v, cout), dtype=feats.dtype, device=feats.device)
    if v == 0:
        return out
    lib = build()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.mopa_subm_conv_fwd(
            feats.data_ptr(), ranks.data_ptr(), sel.data_ptr(),
            weight.data_ptr(),
            out.data_ptr(), v, cin, cout, int(feats.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError("K1 launch failed with CUDA error {}".format(err))
    launches["K1 submanifold_conv_fwd"] += 1
    return out
