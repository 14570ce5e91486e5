#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``mopa_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Build the K1 kernel (``mopa_tpu_torch/csrc/submanifold_conv.cu``, nvcc for
   sm_90a, into ``mopa_tpu_torch/_build/``); print the card's name and power
   limit, the build seconds and the compiler's register/spill report.
2. Hold K1 against its plain PyTorch twin (``submanifold_conv_wide_ref``) on
   the card at every (Cin, Cout) of the SCN UNet's 14 submanifold convs, on
   the plans of one and of eight seeded 16,384-point synthetic scans: float32
   to atol = rtol = 1e-4, bfloat16 to max|err| <= 2e-2 * max|ref|. Time each
   with CUDA events (median of 20 launches after a warm-up), beside the twin,
   and compute the card's bound for the same work.
3. The eval step at full width (UNetResNet34 + SCN m=16, 7 planes, 10 classes,
   dual heads, 302x480 images, 16,384-point budget) in bfloat16: 3 requests
   of batch 1, then 1 of batch 8, with launch counts reset just before and
   read just after (14 K1 launches per 3D forward). Then the same requests
   with the plain twin swapped in: argmax agreement >= 0.99 on valid points
   and max probability delta <= 2e-2. One batch-1 request in float32 against
   the plain twin on the card and against the whole port on the CPU, to
   atol 1e-3. Per-request milliseconds and peak memory are printed, then
   5 warm requests of each shape and one request traced by
   ``torch.profiler`` (device busy share, kernel times, and the stage
   ranges that ``make_eval_step`` marks).
4. Print the kernels line (JSON), the card line, then
   ``{"ok": true, "device": {...}}`` as the last line.

Weights are random from a seed. Details go to ``chiprun_out/chip_smoke.json``.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

POINT_BUDGET = 16384
IMAGE_SIZE = (480, 302)  # (W, H), the KITTI geometry of bench.py
NUM_CLASSES = 10
TIMED_LAUNCHES = 20
WARM_REQUESTS = 5


def fail(msg: str) -> None:
    print("chip_smoke FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail("nvidia-smi failed: " + res.stderr)
    return res.stdout.strip().splitlines()[0]


def make_cfg(dtype: str):
    """The shipped a2d2_semantic_kitti/xmuda_pl_mopa.yaml model pair, in code
    (no YAML on the card's machine)."""
    from mopa_tpu_torch.config.xmuda import cfg

    c = cfg.clone()
    c.MODEL_2D.TYPE = "UNetResNet34"
    c.MODEL_3D.TYPE = "SCN"
    c.MODEL_2D.NUM_CLASSES = NUM_CLASSES
    c.MODEL_3D.NUM_CLASSES = NUM_CLASSES
    c.MODEL_2D.DUAL_HEAD = True
    c.MODEL_3D.DUAL_HEAD = True
    c.MODEL_3D.SCN.m = 16
    c.MODEL_3D.SCN.num_planes = 7
    c.TPU.POINT_BUDGET = POINT_BUDGET
    c.TPU.COMPUTE_DTYPE = dtype
    c.RNG_SEED = 0
    c.freeze()
    return c


def conv_shapes(m: int = 16, num_planes: int = 7):
    """(name, level, Cin, Cout) of the 14 submanifold convs of one forward."""
    planes = [(i + 1) * m for i in range(num_planes)]
    out = [("stem", 0, 1, m)]
    for l, p in enumerate(planes):
        out.append(("l{}_conv1".format(l), l, p, p))
    for l, p in enumerate(planes[:-1]):
        out.append(("l{}_conv2".format(l), l, 2 * p, p))
    return out


def cuda_median_ms(fn, n: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase(plans: dict, device) -> list:
    """K1 vs its plain twin at every conv shape of every plan and dtype."""
    import torch

    from mopa_tpu_torch.ops import sparse_conv as sc
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc

    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for plan_name, plan in plans.items():
        for name, level, cin, cout in conv_shapes():
            lv = plan.levels[level]
            v = lv.valid.shape[0]
            codes = lv.sel.long()
            pairs = sum(int((((codes >> (2 * j)) & 3) != 3).sum())
                        for j in range(3))
            for dtype in (torch.float32, torch.bfloat16):
                feats = torch.randn((v, cin), generator=gen, device=device,
                                    dtype=torch.float32).to(dtype)
                w = (torch.randn((27, cin, cout), generator=gen,
                                 device=device)
                     * (2.0 / (27 * cin)) ** 0.5).to(dtype)

                def kern():
                    return scc.submanifold_conv_wide_cuda(feats, lv.ranks,
                                                          lv.sel, w)

                def plain():
                    return sc.submanifold_conv_wide_ref(feats, lv.ranks,
                                                        lv.sel, w)

                got, ref = kern().float(), plain().float()
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                ref_max = float(ref.abs().max())
                if dtype == torch.float32:
                    ok = bool(((got - ref).abs()
                               <= 1e-4 + 1e-4 * ref.abs()).all())
                    tol = "atol=rtol=1e-4"
                else:
                    ok = err <= 2e-2 * ref_max
                    tol = "max|err| <= 2e-2*max|ref|"
                if not ok or not torch.isfinite(got).all():
                    fail("K1 disagrees with its plain twin at {} {} {}: "
                         "max|err| {} (max|ref| {}, {})".format(
                             plan_name, name, dtype, err, ref_max, tol))
                esz = feats.element_size()
                nbytes = (v * cin * esz + 2 * v * 9 * 4
                          + 27 * cin * cout * esz + v * cout * esz)
                flops = 2 * cin * cout * pairs
                dt_name = str(dtype).split(".")[-1]
                rows.append({
                    "plan": plan_name, "conv": name, "cin": cin, "cout": cout,
                    "voxel_rows": v, "neighbour_pairs": pairs,
                    "dtype": dt_name, "max_abs_err": err, "max_abs_ref": ref_max,
                    "tolerance": tol,
                    "ms": cuda_median_ms(kern),
                    "plain_ms": cuda_median_ms(plain),
                    "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "ops_ms": flops / PEAK_FLOPS[dt_name] * 1e3,
                })
    return rows


def plain_twin():
    """Patch the 3D net's submanifold conv to the plain twin."""
    from mopa_tpu_torch.ops import sparse_conv as sc

    def plain(feats, plan, weight):
        return sc.submanifold_conv_wide_ref(feats, plan.ranks, plan.sel,
                                            weight)

    return mock.patch.object(sc, "submanifold_conv_wide", plain)


def check_outputs(out, batch, tag: str) -> None:
    import torch

    b, p = batch["img_indices"].shape[:2]
    for name, t in zip(("probs_2d", "probs_3d"), out[:2]):
        if tuple(t.shape) != (b * p, NUM_CLASSES) or not bool(
                torch.isfinite(t).all()):
            fail("{} {}: bad shape {} or non-finite".format(tag, name,
                                                            tuple(t.shape)))
        if float((t.float().sum(-1) - 1).abs().max()) > 1e-3:
            fail("{} {}: rows do not sum to 1".format(tag, name))
    for name, t in zip(("seg_loss_2d", "seg_loss_3d"), out[2:]):
        if not bool(torch.isfinite(t)):
            fail("{} {} is not finite".format(tag, name))


def valid_mask(batch):
    import numpy as np

    p = batch["img_indices"].shape[1]
    return (np.arange(p)[None, :] < batch["num_points"][:, None]).reshape(-1)


def compare(a, b, batch, tag: str, *, atol=None, agree_min=None,
            delta_max=None) -> dict:
    import torch

    valid = torch.from_numpy(valid_mask(batch)).to(a[1].device)
    res = {}
    for name, x, y in (("2d", a[0], b[0]), ("3d", a[1], b[1])):
        x, y = x.float()[valid], y.to(x.device).float()[valid]
        delta = float((x - y).abs().max())
        agree = float((x.argmax(-1) == y.argmax(-1)).float().mean())
        res[name] = {"max_prob_delta": delta, "argmax_agreement": agree}
        if atol is not None and delta > atol:
            fail("{} probs_{}: max delta {} > {}".format(tag, name, delta,
                                                         atol))
        if delta_max is not None and delta > delta_max:
            fail("{} probs_{}: max delta {} > {}".format(tag, name, delta,
                                                         delta_max))
        if agree_min is not None and agree < agree_min:
            fail("{} probs_{}: argmax agreement {} < {}".format(
                tag, name, agree, agree_min))
    return res


def timed_request(step, batch) -> tuple:
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, torch.cuda.max_memory_allocated() / 2 ** 20


def profile_request(step, batch, top: int = 12) -> dict:
    """Device time by kernel name, the device's busy share, and each stage's
    times over one request traced by ``torch.profiler`` (tracing adds host
    overhead).

    The stages are the ``record_function`` ranges of ``make_eval_step``
    (``validate.STAGES``): ``host_ms`` is the range on the host clock,
    ``device_span_ms`` its extent on the card's timeline (first to last of
    its kernels), ``device_kernel_ms`` the kernel time inside that extent."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mopa_tpu_torch.data.utils.validate import STAGES

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    host_us = dict.fromkeys(STAGES, 0.0)
    card_span = {}
    kernels = []
    for e in prof.events():
        on_card = getattr(e, "device_type", None) == DeviceType.CUDA
        start, end = e.time_range.start, e.time_range.end
        if e.name in host_us:
            if on_card:
                s0, e0 = card_span.get(e.name, (start, end))
                card_span[e.name] = (min(s0, start), max(e0, end))
            else:
                host_us[e.name] += end - start
            continue
        if on_card and not getattr(e, "is_user_annotation", False):
            kernels.append((e.name, start, end))
    if not kernels:
        return {"device_time": "not measured (no device events traced)"}
    stages = {}
    for name in STAGES:
        st = {"host_ms": host_us[name] / 1e3,
              "device_span_ms": "not measured",
              "device_kernel_ms": "not measured"}
        if name in card_span:
            s0, e0 = card_span[name]
            st["device_span_ms"] = (e0 - s0) / 1e3
            st["device_kernel_ms"] = sum(
                e - s for _, s, e in kernels if s0 <= s < e0) / 1e3
        stages[name] = st
    busy, cur_s, cur_e, by_name = 0.0, None, None, {}
    for name, s, e in sorted(kernels, key=lambda k: k[1]):
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    names = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "device_kernel_ms_total": sum(by_name.values()) / 1e3,
            "stages": stages,
            "top_device_ms": [[n[:90], us / 1e3] for n, us in names[:top]]}


def warm_requests(step, batch, n: int = WARM_REQUESTS) -> list:
    """Host-clock milliseconds of ``n`` back-to-back requests on a shape the
    step has already run (cuDNN plans and allocator pools warm)."""
    return [timed_request(step, batch)[1] for _ in range(n)]


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if not (ROOT / "mopa_tpu_torch" / "csrc").is_dir():
        fail("run from a checkout of the repository (mopa_tpu_torch missing)")
    sys.path.insert(0, str(ROOT))

    from mopa_tpu_torch.data import synthetic
    from mopa_tpu_torch.data.utils.validate import make_eval_step
    from mopa_tpu_torch.ops import sparse_conv_cuda as scc
    from mopa_tpu_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    report = {"card": card_line()}
    print(report["card"], flush=True)

    # -- phase 1: build
    t0 = time.perf_counter()
    scc.build()
    report["build_s"] = time.perf_counter() - t0
    log = scc.library_path().with_suffix(".log")
    report["ptxas"] = log.read_text() if log.exists() else "(cached build)"
    print("K1 build: {:.2f} s".format(report["build_s"]))
    print(report["ptxas"].strip())

    # -- data: 3 single-scan requests, then one batch of 8 scans
    batches_1 = [synthetic.eval_batch(1, POINT_BUDGET, start_index=i,
                                      image_size=IMAGE_SIZE) for i in range(3)]
    batch_8 = synthetic.eval_batch(8, POINT_BUDGET, start_index=3,
                                   image_size=IMAGE_SIZE)
    cfg = make_cfg("bfloat16")

    # -- phase 2: K1 against its plain twin at every conv shape on the path
    plans = {}
    for name, batch in (("batch1", batches_1[0]), ("batch8", batch_8)):
        b, p = batch["img_indices"].shape[:2]
        valid = torch.from_numpy(valid_mask(batch)).to(device)
        coords = torch.from_numpy(batch["coords"]).to(device)
        plans[name] = trainer.build_plan_from_batch(cfg, coords, valid, p)
        report["num_voxels_" + name] = plans[name].num_voxels.tolist()
    rows = kernel_phase(plans, device)
    report["kernel_rows"] = rows
    for r in rows:
        print("K1 {plan} {conv} ({cin},{cout}) {dtype}: {ms:.4f} ms "
              "(plain {plain_ms:.4f} ms, bound {b:.4f} ms) "
              "max|err| {max_abs_err:.3g}".format(
                  b=max(r["bytes_ms"], r["ops_ms"]), **r))

    # -- phase 3: the eval step, bfloat16, full width
    models = trainer.build_models(cfg, device=device, seed=0)
    step = make_eval_step(cfg, models)
    requests = [("batch1", b) for b in batches_1] + [("batch8", batch_8)]
    scc.reset_launch_counts()
    outs, req_report = [], []
    for tag, batch in requests:
        out, ms, peak = timed_request(step, batch)
        check_outputs(out, batch, tag)
        outs.append(out)
        req_report.append({"request": tag, "ms": ms, "peak_mib": peak})
        print("eval request {} bf16: {:.2f} ms, peak {:.0f} MiB".format(
            tag, ms, peak))
    launches = dict(scc.launches)
    expected = len(conv_shapes()) * len(requests)
    if launches["K1 submanifold_conv_fwd"] != expected:
        fail("K1 launched {} times on the main path, expected {}".format(
            launches["K1 submanifold_conv_fwd"], expected))
    report["requests"] = req_report
    report["launches"] = launches

    with plain_twin():
        for (tag, batch), out, rr in zip(requests, outs, req_report):
            ref, ms, _ = timed_request(step, batch)
            rr["plain_ms"] = ms
            rr["vs_plain"] = compare(out, ref, batch, tag + " bf16",
                                     agree_min=0.99, delta_max=2e-2)
            print("  {} vs plain twin: {}".format(tag, rr["vs_plain"]))

    # warm request latency and batch-8 throughput (after the counted window)
    warm = {"batch1": warm_requests(step, batches_1[0]),
            "batch8": warm_requests(step, batch_8)}
    report["warm_requests_ms"] = warm
    report["warm_batch1_median_ms"] = statistics.median(warm["batch1"])
    report["warm_batch8_median_ms"] = statistics.median(warm["batch8"])
    report["warm_batch8_scans_per_s"] = 8e3 / report["warm_batch8_median_ms"]
    print("warm eval requests bf16 (ms): batch1 {} batch8 {}; batch8 "
          "median {:.2f} ms = {:.1f} scans/s".format(
              warm["batch1"], warm["batch8"], report["warm_batch8_median_ms"],
              report["warm_batch8_scans_per_s"]))
    # where the time goes in a batch-8 request
    report["profile_batch8"] = profile_request(step, batch_8)
    print("eval profile batch8 bf16: {}".format(report["profile_batch8"]))
    del models, step, outs

    # f32: kernel vs plain twin on the card, and vs the whole port on the CPU
    cfg32 = make_cfg("float32")
    models32 = trainer.build_models(cfg32, device=device, seed=0)
    step32 = make_eval_step(cfg32, models32)
    b = batches_1[0]
    out32, ms32, _ = timed_request(step32, b)
    check_outputs(out32, b, "batch1 f32")
    with plain_twin():
        ref32 = step32(b)
    cpu_models = trainer.build_models(cfg32, device="cpu", seed=0)
    cpu32 = make_eval_step(cfg32, cpu_models)(b)
    report["f32"] = {
        "ms": ms32,
        "vs_plain": compare(out32, ref32, b, "batch1 f32", atol=1e-3),
        "vs_cpu": compare(out32, cpu32, b, "batch1 f32 vs cpu", atol=1e-3)}
    print("eval request batch1 f32: {:.2f} ms; vs plain {}; vs cpu {}".format(
        ms32, report["f32"]["vs_plain"], report["f32"]["vs_cpu"]))

    # -- phase 4: summary lines
    main_rows = [r for r in rows
                 if r["plan"] == "batch8" and r["dtype"] == "bfloat16"]
    bytes_ms = sum(r["bytes_ms"] for r in main_rows)
    ops_ms = sum(r["ops_ms"] for r in main_rows)
    kernels = [{
        "name": "K1 submanifold_conv_fwd",
        "route": "cuda",
        "source": "mopa_tpu_torch/csrc/submanifold_conv.cu",
        "replaces": "mopa_tpu/ops/sparse_conv_pallas.py:75",
        "launches": launches["K1 submanifold_conv_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) for r in main_rows),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
