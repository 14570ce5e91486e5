"""Run one cell of the benchmark once, on the card it is started on.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer ones with ``--trace 1``), ``device`` and, when
traced, ``breakdown``; last, ``compared``: each number the correctness
check compared, with its limit, which also end standard error. Exits
non-zero, printing no result, without enough CUDA cards, or if JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches of the program's builds stay inside the checkout, at fixed
    # paths; a library that could pull in JAX is kept from it
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "benchmark" / "_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "benchmark" / "_cache" / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import core, runner

    work = core.cell(args.workload, ROOT)[0]
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(work["chips"]):
        print("needs {} CUDA card(s), found {}".format(
            work["chips"], torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    result, note = runner.run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", t_start=T_START,
                             root=ROOT)
    found = core.forbidden_modules()
    if found:
        print("loaded modules of JAX or the JAX package: {}".format(found),
              file=sys.stderr)
        return 3
    if note:
        print(note, file=sys.stderr)
    for k, c in result["compared"].items():
        print("compared {} {!r} limit {!r}".format(k, c["value"],
                                                    c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
