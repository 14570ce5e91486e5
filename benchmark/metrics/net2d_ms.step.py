"""Device ms a train step under ``train/net2d``: UNetResNet34's forward,
lifting and heads."""


def read(ctx):
    tr, steps = ctx["trace"], ctx["info"]["steps"]
    if tr is None or not steps or "train/net2d" not in tr.stage_ms:
        return None
    return tr.stage_ms["train/net2d"] / steps
