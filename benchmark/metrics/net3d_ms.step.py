"""Device ms a train step under ``train/net3d``: the 3D net's forward over
the fused plan (K1 and the strided convs) and its heads."""


def read(ctx):
    tr, steps = ctx["trace"], ctx["info"]["steps"]
    if tr is None or not steps or "train/net3d" not in tr.stage_ms:
        return None
    return tr.stage_ms["train/net3d"] / steps
