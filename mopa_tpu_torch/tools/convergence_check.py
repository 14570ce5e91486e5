"""Synthetic end-to-end convergence gate (PyTorch port of
``tools/convergence_check.py``).

    python -m mopa_tpu_torch.tools.convergence_check [--iters N]

Trains the full MoPA recipe (xM KL + pseudo-labels + SAM consistency + VGI,
through the EMA phase switch) with :func:`train.common.train` on the
LEARNABLE synthetic dataset (box class in box height for 3D, point-pixel
colour for 2D), then evaluates through ``validate()`` on FRESH val scans
and holds the mIoUs to the gates. ``--iters`` defaults to ``CONV_ITERS``
(500); the gate's recorded run is 3,000 iterations. Runs on the card unless
``main(..., device="cpu")`` is called.

Prints one JSON line (``iters``, ``miou``, ``gate``, ``pass``) and exits
1 when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp
import sys

GATE_2D = 0.70
GATE_XM = 0.70
# the 3D branch learns pure geometry from constant-1 features; its gate
# proves the sparse-conv stack trains to a real optimum
GATE_3D = 0.50

SMOKE_YAML = osp.join(osp.dirname(osp.dirname(osp.dirname(
    osp.abspath(__file__)))), "configs", "synthetic", "mopa_smoke.yaml")


def convergence_cfg(n_iter: int):
    """The frozen gate config: ``mopa_smoke.yaml`` on the learnable
    synthetic set, ``n_iter`` iterations through the EMA switch."""
    from mopa_tpu_torch.config.xmuda import cfg

    c = cfg.clone()
    c.merge_from_file(SMOKE_YAML)
    for d in (c.DATASET_SOURCE.SyntheticSCN, c.DATASET_TARGET.SyntheticSCN):
        d.learnable = True
        d.length = 32
        d.n_points = 2048
        d.image_size = (128, 96)
    c.SCHEDULER.MAX_ITERATION = n_iter
    c.SCHEDULER.MultiStepLR.milestones = (int(n_iter * 0.8),)
    c.TRAIN.BATCH_SIZE = 4
    c.VAL.BATCH_SIZE = 4
    c.VAL.PERIOD = n_iter
    c.TRAIN.LOG_PERIOD = 50
    c.TRAIN.CHECKPOINT_PERIOD = 0
    c.TRAIN.PC_MM.ema_start_iter = int(n_iter * 0.7)  # through the EMA switch
    # log-inverse-frequency class weights, as every real config has them:
    # the synthetic scans are ~55% road (class 4), and the unweighted CE
    # lets the 3D head collapse to the majority class in a short schedule
    c.TRAIN.CLASS_WEIGHTS = [2.6, 2.6, 2.6, 2.6, 1.0,
                             2.6, 2.6, 2.6, 2.6, 2.6]
    c.TPU.POINT_BUDGET = 1024
    # overflow-free level capacities at the 1024-point budget (the true
    # dedup curve peaks at [1012, 984, 877, 590, 301, 154, 81])
    c.TPU.CAP_FACTORS = (1.0, 1.0, 0.95, 0.65, 0.35, 0.2, 0.125)
    c.RNG_SEED = 7
    c.OUTPUT_DIR = ""
    c.freeze()
    return c


def gate_result(n_iter: int, eval_dict: dict) -> dict:
    """The JSON line: the mIoUs of ``eval_dict`` against the gates."""
    ious = {name: float(ev.overall_iou)
            for name, ev in eval_dict.items()} if eval_dict else {}
    ok = (ious.get("2D", 0.0) >= GATE_2D
          and ious.get("3D", 0.0) >= GATE_3D
          and ious.get("2D+3D", 0.0) >= GATE_XM)
    return {"iters": n_iter, "miou": ious,
            "gate": {"2D": GATE_2D, "3D": GATE_3D, "2D+3D": GATE_XM},
            "pass": bool(ok)}


def run(n_iter: int, device="cuda", logger=None):
    """Train the gate config for ``n_iter`` iterations on ``device``;
    returns (state, eval_dict, the JSON line's dict)."""
    from mopa_tpu_torch.train.common import train

    logger = logger or logging.getLogger("mopa_tpu_torch.convergence")
    state, eval_dict = train(convergence_cfg(n_iter), logger, output_dir="",
                             run_name="convergence", device=device)
    return state, eval_dict, gate_result(n_iter, eval_dict)


def main(argv=None, device="cuda"):
    parser = argparse.ArgumentParser(description="Synthetic convergence gate")
    parser.add_argument("--iters", type=int,
                        default=int(os.environ.get("CONV_ITERS", 500)))
    args = parser.parse_args(argv)
    if device != "cpu":
        from mopa_tpu_torch.train.common import require_cuda

        require_cuda()
    logging.basicConfig(level=logging.INFO)
    _, _, result = run(args.iters, device=device)
    print(json.dumps(result))
    sys.exit(0 if result["pass"] else 1)


if __name__ == "__main__":
    main()
