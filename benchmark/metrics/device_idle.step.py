"""Share of the traced window of train steps in which no kernel ran on
the device, in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
