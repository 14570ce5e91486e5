"""Device ms a train step under ``train/optim`` and ``train/ema``: both
nets' Adam updates and the EMA parameters' update."""


def read(ctx):
    tr, steps = ctx["trace"], ctx["info"]["steps"]
    if tr is None or not steps:
        return None
    ms = [tr.stage_ms[s] for s in ("train/optim", "train/ema")
          if s in tr.stage_ms]
    return sum(ms) / steps if ms else None
