"""Share of the patch attention's layout slots that hold a real patch's
token: the tokens of the real patches a step (the 3D net's
``ptv3_attn_tokens``, forward) over the layout slots the program ran a
step (its counter ``ptv3.attn``, padding included, as its span record,
``mopa_tpu_torch.common.spans``, copied it at each traced step's start and
end), in %. None where the program keeps no such counter."""


def read(ctx):
    steps = ctx["info"]["steps"]
    real = ctx["work"].get("ptv3_attn_tokens")
    if not steps or not real:
        return None
    try:
        from mopa_tpu_torch.common import spans
    except ImportError:
        return None
    runs = [s for s in spans.record().last(steps).steps
            if "ptv3.attn" in s.after and "ptv3.attn" in s.before]
    if not runs:
        return None
    ran = sum(s.after["ptv3.attn"]["tokens"] - s.before["ptv3.attn"]["tokens"]
              for s in runs) / len(runs)
    if ran <= 0:
        return None
    return 100.0 * real / steps / ran
