"""The whole train step's share of the chip's peak: the model operations
of the window's steps (forward and a backward of twice the forward, each
at the peak of its operands' dtype; ``harness.counts``) over the traced
window's seconds, in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0 or not ctx["info"]["steps"]:
        return None
    return 100.0 * ctx["work"]["model_peak_s"] / tr.window_s
