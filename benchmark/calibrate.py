"""The readings that a cell's correctness limits are set from: for each
seed, in one process, the program's numbers against the reference's and
the control's (the reference computed in the configuration's next lower
precision) against the reference's, or with ``--fault`` the program's with
that fault planted. A short window (``--seconds``) runs before the check,
as in a run. Each reading is also judged against the cell's own limits
(``control_correct``, ``correct``), as a run judges the program's.

    python benchmark/calibrate.py --workload <name> --seeds 1 2 3 \
        [--no-control] [--fault <name>] [--out <file.jsonl>]

Prints one JSON line a seed.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--fault", default="",
                    help="a fault of harness/faults.py planted in the "
                         "program (its readings, no control)")
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="a short window before the check")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import core, faults
    from benchmark.harness.runner import judge

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    _, _, conf, traffic = core.cell(args.workload, ROOT)
    # the train readings come from the first steps: a pool of as many
    # batches gives the same readings
    if "pool" in traffic and traffic["driver"].endswith("_train"):
        traffic = dict(traffic, pool=3)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        drv = core.driver(traffic).Driver(conf, traffic, seed, "cuda")
        fault = (faults.TRAIN[args.fault]
                 if args.fault else faults.unbroken)
        with fault():
            drv.setup()
            drv.window(args.seconds)
            drv.release()
        nums = drv.check(control=not (args.no_control or args.fault))
        limits = traffic.get("limits", {})
        verdicts = {("control_correct" if who == "control" else "correct"):
                    judge(v, limits)[1] for who, v in nums.items()}
        detail = {}
        cell = getattr(drv, "cell", None)
        if cell is not None:
            detail = {"worst": cell.worst, "phases": cell.phases.seconds}
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "fault": args.fault,
                           "seconds": time.perf_counter() - t0, **nums,
                           **verdicts,
                           **detail})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del drv
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
