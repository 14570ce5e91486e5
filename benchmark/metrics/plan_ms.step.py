"""Device ms a train step under ``train/plan``: the voxel plan decoded from
the batch's host plans (and the cat scans' plan)."""


def read(ctx):
    tr, steps = ctx["trace"], ctx["info"]["steps"]
    if tr is None or not steps or "train/plan" not in tr.stage_ms:
        return None
    return tr.stage_ms["train/plan"] / steps
