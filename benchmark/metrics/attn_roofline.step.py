"""Share of its roofline that the traced window's patch attention reaches:
the least time of its real patches (the 3D net's ``ptv3_attn_least_s``,
``benchmark/reference/nets3d/ptv3.py::work``: per patch and head, forward
and backward, the larger of the products at the bfloat16 peak, the
exponentials at the special-function units' rate and q, k, v, o and their
gradients moved once) over the device time of the kernels whose name holds
``flash``, in %. None where no such kernel ran or the net counts no
attention."""

FRAGMENT = "flash"


def read(ctx):
    tr = ctx["trace"]
    least = ctx["work"].get("ptv3_attn_least_s")
    if tr is None or not least:
        return None
    spent = tr.kernel_s(lambda n: FRAGMENT in n)
    if spent <= 0:
        return None
    return 100.0 * least / spent
