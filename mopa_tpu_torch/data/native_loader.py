"""ctypes binding of the port's host-side voxel-plan builder
(``mopa_tpu_torch/csrc/host_plan.cpp``, a copy of the JAX package's
``mopa_build_plan3``; the port of ``mopa_tpu/data/native_loader.py::
build_plan_arrays``), and the raw scan reads of SemanticKITTI
(``read_scan``, ``read_labels``: numpy file reads, the JAX module's own
fallback for its C++ readers).

The library is compiled at first use by the host C++ compiler (``$CXX``, else
``c++``: ``-O3 -std=c++17 -shared -fPIC``) into ``mopa_tpu_torch/_build/``,
named by the hash of the source. A missing compiler or a failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host_plan.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# Nibble deltas above 14 ship as fixup entries; LiDAR-geometry samples of
# 16,384 points need ~6k (unrotated) to ~10k (augmented). On overflow the
# builder returns -2 and the batch ships without that group's plan keys.
FIXUP_BUDGET = 16384

# Rows the JAX package's C++ scan readers hold; a longer file raises here
# where they would cut it short.
SCAN_CAPACITY = 200000

_LIB = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / "lib{}_{}.so".format(SOURCE.stem, digest)


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler: set CXX or install c++")
    return cxx


def build():
    """Build (once per source version) and load the plan builder."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name("{}.{}.tmp".format(so.name, os.getpid()))
        cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("host plan build failed (rc {}): {}\n{}".format(
                res.returncode, " ".join(cmd), res.stderr))
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    i32, u8 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    cint = ctypes.c_int
    lib.mopa_build_plan3.argtypes = [
        i32, u8, cint, cint, i32, i32, i32, u8, u8, u8, u8, u8,
        ctypes.POINTER(ctypes.c_int16), u8, i32, cint, i32]
    lib.mopa_build_plan3.restype = cint
    _LIB = lib
    return lib


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def build_plan_arrays(coords: np.ndarray, valid: np.ndarray,
                      capacities) -> dict | None:
    """One sample's UNet voxel plan in the delta-compressed wire format (v3;
    ``csrc/host_plan.cpp``), which ``models.scn_unet.plan_from_host_arrays``
    decodes.

    Args:
        coords: (P, 3) integer voxel coordinates.
        valid: (P,) bool.
        capacities: per-level voxel capacities.

    Returns the arrays ``rankn``, ``ebits``, ``cbits``, ``downn``,
    ``downe``, ``f2c`` (int16), ``upoffn``, ``fix`` (int32, -1 past the
    used entries), ``inverse``, ``counts`` and ``nums`` (int32), or None
    when the fixups overflow :data:`FIXUP_BUDGET`. Any other failure
    raises."""
    lib = build()
    caps = np.ascontiguousarray(capacities, np.int32)
    nl = len(caps)
    coords = np.ascontiguousarray(coords, np.int32)
    valid_u8 = np.ascontiguousarray(valid, np.uint8)
    n = coords.shape[0]
    if coords.shape != (n, 3) or valid_u8.shape != (n,) or caps.ndim != 1:
        raise ValueError("build_plan_arrays takes (P, 3) coords, (P,) valid "
                         "and a 1-D capacity list; got {}, {}, {}".format(
                             coords.shape, valid_u8.shape, caps.shape))
    sum1 = int(caps.sum())
    sum8 = int(caps[1:].sum()) * 8
    sumf = int(caps[:-1].sum())
    sumc = int(sum((int(c) + 7) // 8 for c in caps))
    inverse = np.empty(n, np.int32)
    counts = np.empty(int(caps[0]), np.int32)
    rankn = np.empty((sum1 * 8 + 1) // 2, np.uint8)
    ebits = np.empty(sum1 * 3, np.uint8)
    cbits = np.empty(sumc, np.uint8)
    downn = np.empty(max((sum8 + 1) // 2, 1), np.uint8)
    downe = np.empty(max(int(caps[1:].sum()), 1), np.uint8)
    f2c = np.empty(max(sumf, 1), np.int16)
    upoffn = np.empty(max((sumf + 1) // 2, 1), np.uint8)
    fix = np.empty(FIXUP_BUDGET, np.int32)
    nums = np.empty(nl, np.int32)
    rc = lib.mopa_build_plan3(
        _ptr(coords, ctypes.c_int32), _ptr(valid_u8, ctypes.c_uint8),
        n, nl, _ptr(caps, ctypes.c_int32),
        _ptr(inverse, ctypes.c_int32), _ptr(counts, ctypes.c_int32),
        _ptr(rankn, ctypes.c_uint8), _ptr(ebits, ctypes.c_uint8),
        _ptr(cbits, ctypes.c_uint8),
        _ptr(downn, ctypes.c_uint8), _ptr(downe, ctypes.c_uint8),
        _ptr(f2c, ctypes.c_int16), _ptr(upoffn, ctypes.c_uint8),
        _ptr(fix, ctypes.c_int32), FIXUP_BUDGET,
        _ptr(nums, ctypes.c_int32))
    if rc == -2:
        return None
    if rc != 0:
        raise ValueError("mopa_build_plan3 rejected its arguments (rc {}): "
                         "{} points, capacities {}".format(rc, n,
                                                           caps.tolist()))
    return {"inverse": inverse, "counts": counts, "nums": nums,
            "rankn": rankn, "ebits": ebits, "cbits": cbits,
            "downn": downn[:(sum8 + 1) // 2],
            "downe": downe[:int(caps[1:].sum())],
            "f2c": f2c[:sumf], "upoffn": upoffn[:(sumf + 1) // 2],
            "fix": fix}


def _check_rows(path: str, n: int) -> None:
    if n > SCAN_CAPACITY:
        raise ValueError("{} holds {} rows, more than the capacity {}".format(
            path, n, SCAN_CAPACITY))


def read_scan(path: str) -> np.ndarray:
    """A velodyne ``.bin`` scan as (N, 4) float32 x, y, z, remission."""
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    _check_rows(path, scan.shape[0])
    return scan


def read_labels(path: str) -> np.ndarray:
    """A SemanticKITTI ``.label`` file as (N,) int32 semantic ids (the
    lower 16 bits; the upper hold the instance)."""
    lab = np.fromfile(path, dtype=np.uint32)
    _check_rows(path, lab.shape[0])
    return (lab & 0xFFFF).astype(np.int32)
