"""One run of one cell: set-up, the measured window (``trace`` 0) or the
traced one (``trace`` 1), the program freed, then the check against the
reference. Returns the result line's object (the numbers compared, with
their limits, under its last key ``compared``) and a note for standard
error ("" or a line the driver leaves, such as a tail's sample count)."""

from __future__ import annotations

import time

import torch

from benchmark.harness import core


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             conf_cfg: dict | None = None, traffic_over: dict | None = None,
             root=core.ROOT) -> tuple:
    """``conf_cfg`` / ``traffic_over`` replace parts of the configuration's
    ``cfg`` and of the traffic file (the CPU tests' small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    _, _, conf_file, traffic = core.cell(name, root)
    if conf_cfg is not None:
        conf_file = dict(conf_file, cfg=conf_cfg)
    traffic = dict(traffic, **(traffic_over or {}))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    drv = core.driver(traffic).Driver(conf_file, traffic, seed, dev)
    drv.setup()
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    metrics, breakdown = {}, None
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1}
    if not trace:
        values = drv.window(seconds)
        peak_win = torch.cuda.max_memory_allocated(dev) if cuda else 0
        values["setup_s"] = setup_s
        values["peak_mem_gib"] = peak_win / 2 ** 30
        for m in core.metrics_for(name, "end_to_end", root):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        from benchmark.harness.trace import traced

        info, tr = traced(lambda: drv.traced_window(seconds), drv.stages) \
            if cuda else (drv.traced_window(seconds), None)
        peak_win = torch.cuda.max_memory_allocated(dev) if cuda else 0
    device_info["memory_peak_bytes"] = int(max(peak_setup, peak_win))
    drv.release()
    if trace:
        ctx = {"trace": tr, "info": info, "work": drv.work(info)}
        for m in core.metrics_for(name, "per_layer", root):
            v = core.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tr is not None:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.device_ops,
                         "idle_gaps": tr.idle_gaps}
    compared, correct = judge(drv.check()["program"],
                              traffic.get("limits", {}))
    result = {"correct": correct, "attempted": drv.attempted(),
              "failed": drv.failed(), "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result, getattr(drv, "note", "")


def judge(numbers: dict, limits: dict) -> tuple:
    """(each number beside its limit, correct): correct where every
    number has a limit, every limit its number, and no number is above
    its limit (a NaN is above any)."""
    compared = {k: {"value": v, "limit": limits.get(k)}
                for k, v in numbers.items()}
    correct = bool(compared) and set(limits) <= set(numbers) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in compared.values())
    return compared, correct
