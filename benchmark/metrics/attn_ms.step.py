"""Device ms a train step of the patch attention's kernels, forward and
backward: every kernel of the traced window whose name holds ``flash``
(the fragment the program's attention kernels carry, PyTorch's flash SDPA
kernels or a kernel written to replace them), over the window's steps.
None where no such kernel ran."""

FRAGMENT = "flash"


def read(ctx):
    tr, steps = ctx["trace"], ctx["info"]["steps"]
    if tr is None or not steps:
        return None
    spent = tr.kernel_s(lambda n: FRAGMENT in n)
    return spent * 1e3 / steps if spent > 0 else None
