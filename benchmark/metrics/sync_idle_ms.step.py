"""Device idle ms a train step that opens while the host waits on the
device: the gaps between the traced window's merged kernel intervals whose
start falls inside one of the program's ``sync/*`` spans (its span record,
``mopa_tpu_torch.common.spans``, on the trace's clock, over the window's
steps: the record's last ones), summed over the window and divided by its
steps. None where the program keeps no record or marks no wait."""


def read(ctx):
    try:
        from mopa_tpu_torch.common import spans
    except ImportError:
        return None
    tr, steps = ctx["trace"], ctx["info"]["steps"]
    rec = spans.record().last(steps)
    if tr is None or not steps or not rec:
        return None
    syncs = sorted((s.start_ns, s.end_ns) for s in rec.spans
                   if s.name.startswith("sync/"))
    if not syncs:
        return None
    idle, end = 0, None
    for s, e in sorted((k[1], k[2]) for k in tr.kernels):
        if end is not None and s > end \
                and any(a <= end <= b for a, b in syncs):
            idle += s - end
        end = e if end is None else max(end, e)
    return idle / 1e6 / steps
