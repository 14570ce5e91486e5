"""Device ms a train step under ``train/backward``: autograd through both
nets, K2 ``d_feats`` and ``d_w`` among it."""


def read(ctx):
    tr, steps = ctx["trace"], ctx["info"]["steps"]
    if tr is None or not steps or "train/backward" not in tr.stage_ms:
        return None
    return tr.stage_ms["train/backward"] / steps
