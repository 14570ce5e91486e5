"""The device trace of a traced window, reduced to what the per-layer
metrics read: busy and idle time, device time by kernel name and by stage,
and the longest idle gaps with what the host was doing in them.

A kernel belongs to the stage (a ``record_function`` range) whose host
interval holds the runtime call that launched it, matched by the trace's
correlation id, whatever thread made the call: autograd launches the
backward from a thread of its own while the main thread waits inside its
range. (Copied from the port's ``chip_smoke.py::profile_call``.)
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

_LAUNCH = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list                 # (name, start_ns, end_ns)
    stage_ms: dict                # stage -> device ms of its kernels
    device_ops: list = field(default_factory=list)   # [name, s]
    idle_gaps: list = field(default_factory=list)    # [host range, s]

    def kernel_s(self, pred) -> float:
        return sum(e - s for n, s, e in self.kernels if pred(n)) / 1e9


def traced(fn, stages) -> tuple:
    """Run ``fn()`` under ``torch.profiler`` and return (its result, the
    :class:`Trace` of the call); ``stages`` are the range names to
    attribute kernels to. The window ends with a synchronize."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    ranges = {name: [] for name in stages}
    host_ops, launch_ns, kernels = [], {}, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                kernels.append((name, ev.start_ns(),
                                ev.start_ns() + ev.duration_ns(),
                                ev.correlation_id()))
            continue
        span = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if name in ranges:
            ranges[name].append(span)
        if name.startswith(_LAUNCH):
            launch_ns[ev.correlation_id()] = ev.start_ns()
        elif ev.is_user_annotation() or name in ranges:
            host_ops.append((span[0], span[1], name))

    def stage_of(corr):
        t = launch_ns.get(corr)
        for name, spans in ranges.items():
            if t is not None and any(a <= t <= b for a, b in spans):
                return name
        return None

    stage_ns = {}
    for name, s, e, corr in kernels:
        st = stage_of(corr)
        if st is not None:
            stage_ns[st] = stage_ns.get(st, 0) + (e - s)
    ks = sorted((k[1], k[2], k[0]) for k in kernels)
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, _ in ks:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for s, e, n in ks:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host_ops.sort()
    starts = [h[0] for h in host_ops]

    def doing(a, b):
        """The innermost host range that covers the gap's middle."""
        mid = (a + b) // 2
        best = None
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s, e, n = host_ops[i]
            if s <= mid <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, n)
            if mid - s > 60e9:
                break
        return best[2] if best else "(no host range)"

    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[doing(a, b), (b - a) / 1e9] for a, b in gaps[:10]]
    return out, Trace(window_s=window_s, busy_s=busy / 1e9,
                      kernels=[(n, s, e) for n, s, e, _ in kernels],
                      stage_ms={k: v / 1e6 for k, v in stage_ns.items()},
                      device_ops=[[n[:120], ns / 1e9] for n, ns in ops],
                      idle_gaps=idle)
