"""Host waits on the device a train step: the waits the program's span
record (``mopa_tpu_torch.common.spans``) counted over the traced window's
steps (the record's last ones), in the step and in the copy of its
metrics to the host, over those steps. None where the program keeps no
such record."""


def read(ctx):
    try:
        from mopa_tpu_torch.common import spans
    except ImportError:
        return None
    steps = ctx["info"]["steps"]
    rec = spans.record().last(steps)
    if not rec or not steps:
        return None
    return len(rec.waits) / steps
