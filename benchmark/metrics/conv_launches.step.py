"""K1 and K2 (``d_feats`` and ``d_w``) launches a train step: what the
program's launch counter (``mopa_tpu_torch.ops.sparse_conv_cuda.launches``)
gained over each of the traced window's steps, as its span record
(``mopa_tpu_torch.common.spans``) copied it at the step's start and end,
averaged over those steps (the record's last ones). None where the program
keeps no such record."""


def read(ctx):
    try:
        from mopa_tpu_torch.common import spans
        from mopa_tpu_torch.ops.sparse_conv_cuda import K1, K2_DFEATS, K2_DW
    except ImportError:
        return None
    steps = [s for s in spans.record().last(ctx["info"]["steps"]).steps
             if "launches" in s.after]
    if not steps:
        return None
    return sum(s.after["launches"][k] - s.before["launches"][k]
               for s in steps for k in (K1, K2_DFEATS, K2_DW)) / len(steps)
