"""The gather micro-benchmark on an NVIDIA card (PyTorch port of
``tools/gather_micro.py``).

    python -m mopa_tpu_torch.tools.gather_micro [--probes library,gather,fused] [-n 20]

It measures the op that bounds the sparse conv: a row gather at the level-0
wide-conv shape of the fused 3-domain batch (24 samples x 16,384 slots,
C = 16, 8 wide columns: 3.1M rows of 3C = 48 bfloat16 lanes), alone and fused
with its (V, 24C) x (24C, 16) GEMM. Inputs are the reference's, drawn in its
order from ``np.random.default_rng(0)``: normal bfloat16 features, ranks
sorted per sample, then the normal weight.

Probes (the reference's name in brackets):

* ``library`` [``xla``]: ``torch.index_select`` on the flat table, P1's
  one-call counterpart, and indexing then ``torch.matmul``, P2's function in
  two calls.
* ``gather`` [``pallas``]: P1, ``ops.gather.row_gather``.
* ``fused`` [``fused``]: P2, ``ops.gather.gather_gemm``.

For each it gives the median ms of ``n`` calls after ``WARMUP`` (CUDA events
on the card, the host clock on the CPU), M rows/s, GB/s, the card's bound and
the share of it reached, and a float32 checksum of the output taken outside
the timed window. ``gather`` and ``fused`` also time their plain twins and
hold the kernel's output against the twin's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from mopa_tpu_torch.ops import gather

S, V, C, COUT = 24, 16384, 16, 16
PROBES = ("library", "gather", "fused")
WARMUP = 3

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit); the bounds
# of chip_smoke.py's conv kernels read them too.
HBM_BYTES_PER_S = 3.35e12
# float32 on the CUDA cores; bfloat16 on the tensor cores; float32-accurate
# products as 3xTF32, three TF32 MMAs each: 495 / 3 TFLOP/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12,
              "float32_3xtf32": 495e12 / 3}


def make_inputs(s: int = S, v: int = V, c: int = C, cout: int = COUT,
                device="cuda"):
    """(tab (s, v, 3c) bf16, idx (s, 8v) int32 sorted per sample,
    w (24c, cout) bf16) from the reference's seed and draw order."""
    rng = np.random.default_rng(0)
    tab = torch.from_numpy(rng.normal(size=(s, v, 3 * c)).astype(np.float32))
    idx = np.sort(rng.integers(0, v, size=(s, v * gather.TAPS)),
                  axis=1).astype(np.int32)
    w = torch.from_numpy(rng.normal(size=(24 * c, cout)).astype(np.float32))
    return (tab.to(torch.bfloat16).to(device), torch.from_numpy(idx).to(device),
            w.to(torch.bfloat16).to(device))


def median_ms(fn, n: int, device: torch.device) -> float:
    """Median of ``n`` timed calls of ``fn`` after ``WARMUP`` calls: CUDA
    events on a card, the host clock on the CPU."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(n):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _bound(nbytes: int, flops: int) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _rates(res: dict, rows: int, device: torch.device) -> dict:
    """Rows/s and bytes/s of the median call; the share of the card's bound
    only where the time is the card's."""
    sec = res["ms"] / 1e3
    res.update(mrows_per_s=rows / sec / 1e6, gb_per_s=res["bytes"] / sec / 1e9,
               bound_share=res["bound_ms"] / res["ms"]
               if device.type == "cuda" else None)
    return res


def run_probes(probes=PROBES, n: int = 20, s: int = S, v: int = V,
               c: int = C, cout: int = COUT, device="cuda") -> dict:
    """Run the probes at (s, v, c, cout) on ``device`` and return their
    numbers. P1 and P2 each launch ``WARMUP + n + 1`` times: the timed calls
    and one whose output is checked."""
    device = torch.device(device)
    unknown = set(probes) - set(PROBES)
    if unknown:
        raise ValueError("unknown probes {}".format(sorted(unknown)))
    tab, idx, w = make_inputs(s, v, c, cout, device)
    d = 3 * c
    n_rows = s * v * gather.TAPS
    esz = tab.element_size()
    off = (torch.arange(s, device=device, dtype=torch.int32) * v)[:, None]
    flat_idx = (idx + off).reshape(-1)
    flat_tab = tab.reshape(s * v, d)
    # the table rows this data reads, each once
    used_rows = int((torch.bincount(flat_idx, minlength=s * v) > 0).sum())
    tab_bytes = used_rows * d * esz
    idx_bytes = idx.numel() * idx.element_size()
    out = {"device": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "shape": {"S": s, "V": v, "D": d, "taps": gather.TAPS,
                     "Cout": cout, "rows": n_rows}, "n": n}
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    if "library" in probes:
        lib = {"index_select_ms": median_ms(
            lambda: torch.index_select(flat_tab, 0, flat_idx), n, device),
            "index_matmul_ms": median_ms(
                lambda: torch.matmul(flat_tab[flat_idx].reshape(
                    s * v, gather.TAPS * d), w), n, device)}
        lib["index_select_checksum"] = float(torch.index_select(
            flat_tab, 0, flat_idx).float().sum())
        lib["index_matmul_checksum"] = float(torch.matmul(
            flat_tab[flat_idx].reshape(s * v, gather.TAPS * d), w
        ).float().sum())
        out["library"] = lib

    if "gather" in probes:
        res = _bound(n_rows * d * esz + tab_bytes + idx_bytes, 0)
        res["ms"] = median_ms(lambda: gather.row_gather(tab, idx), n, device)
        got = gather.row_gather(tab, idx)
        ref = gather.row_gather_plain(tab, idx)
        sync()
        res["plain_ms"] = median_ms(lambda: gather.row_gather_plain(tab, idx),
                                    n, device)
        res["checksum"] = float(got.float().sum())
        res["bit_exact"] = bool(torch.equal(got, ref))
        res["max_abs_err"] = float((got.float() - ref.float()).abs().max())
        out["gather"] = _rates(res, n_rows, device)

    if "fused" in probes:
        m_rows = s * v
        res = _bound(tab_bytes + idx_bytes + m_rows * cout * esz
                     + w.numel() * esz, 2 * m_rows * gather.TAPS * d * cout)
        res["ms"] = median_ms(lambda: gather.gather_gemm(tab, idx, w), n,
                              device)
        got = gather.gather_gemm(tab, idx, w)
        ref = gather.gather_gemm_plain(tab, idx, w)
        sync()
        res["plain_ms"] = median_ms(
            lambda: gather.gather_gemm_plain(tab, idx, w), n, device)
        res["checksum"] = float(got.float().sum())
        res["max_abs_err"] = float((got.float() - ref.float()).abs().max())
        res["max_abs_ref"] = float(ref.float().abs().max())
        out["fused"] = _rates(res, n_rows, device)
    return out


def report_lines(res: dict) -> list:
    """Human-readable lines of :func:`run_probes`' result."""
    lines = ["gather probes on {} at {}".format(res["device"], res["shape"])]
    if "library" in res:
        lib = res["library"]
        lines.append("library index_select (P1's one call): {:.4f} ms; "
                     "index + matmul (P2's function, two calls): {:.4f} ms"
                     .format(lib["index_select_ms"], lib["index_matmul_ms"]))
    for key, name in (("gather", gather.P1), ("fused", gather.P2)):
        if key in res:
            r = res[key]
            lines.append(
                "{}: {:.4f} ms (plain {:.4f} ms), {:.1f} M rows/s, {:.1f} "
                "GB/s, H100 bound {:.4f} ms ({}), share of the bound {}; "
                "checksum {:.6g}, max|err| vs plain {:.3g}".format(
                    name, r["ms"], r["plain_ms"], r["mrows_per_s"],
                    r["gb_per_s"], r["bound_ms"], r["bound_by"],
                    "not measured" if r["bound_share"] is None
                    else "{:.3f}".format(r["bound_share"]),
                    r["checksum"], r["max_abs_err"]))
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probes", default=",".join(PROBES))
    ap.add_argument("-n", type=int, default=20)
    args = ap.parse_args(argv)
    res = run_probes(args.probes.split(","), n=args.n)
    for line in report_lines(res):
        print(line)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
