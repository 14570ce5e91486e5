"""Share of their roofline that the traced window's K1 and K2 launches
reach: the sum of each launch's least time (the benchmark's own count of
its operations and bytes, ``harness.counts.conv_kernel_least_s``) over
the sum of the device time of every sparse-conv kernel the window ran
(``subm_conv*``, the float32 route's weight packs included), in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    spent = tr.kernel_s(lambda n: "subm_conv" in n)
    if spent <= 0:
        return None
    return 100.0 * ctx["work"]["conv_least_s"] / spent
