"""What every cell shares: the registry read from ``BENCHMARK.json`` and the
files it names, the program's configuration built from a configuration
file, the seeds, and the check that neither JAX nor the JAX package was
loaded."""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
# top-level module names that no run of the port may load
FORBIDDEN = ("jax", "jaxlib", "flax", "mopa_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def registry(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> tuple:
    """(workload entry, configuration entry, configuration file, traffic
    file) of the cell ``name``."""
    bench = registry(root)
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError("no workload {} in BENCHMARK.json".format(name))
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    conf_file = load_json(root / conf["file"])
    traffic = load_json(root / "benchmark" / "workloads"
                        / (work["name"] + ".json"))
    if traffic["traffic"] != work["traffic"]:
        raise ValueError("{}: traffic {} in BENCHMARK.json, {} in its file"
                         .format(name, work["traffic"], traffic["traffic"]))
    return work, conf, conf_file, traffic


def metrics_for(name: str, kind: str, root: Path = ROOT) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that cell
    ``name`` reports: those listing it, or listing no cells at all."""
    return [m for m in registry(root)[kind]
            if "workloads" not in m or name in m["workloads"]]


def load_module(path: Path, name: str):
    """Import the file ``path`` (its name may hold dots) as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: dict):
    return load_module(BENCH_DIR / "drivers" / (traffic["driver"] + ".py"),
                       "benchmark_driver_" + traffic["driver"])


def reader(metric: str):
    return load_module(BENCH_DIR / "metrics" / (metric + ".py"),
                       "benchmark_metric_" + metric.replace(".", "_"))


def port_cfg(values: dict, seed: int):
    """The program's configuration: its defaults with ``values`` (nested
    dicts as in a configuration file) set over them, keys the defaults
    lack added, and the run's seeds in ``RNG_SEED`` and each dataset's
    ``seed``."""
    from mopa_tpu_torch.common.config import CfgNode
    from mopa_tpu_torch.config.xmuda import cfg as defaults

    def put(node, vals):
        for k, v in vals.items():
            if isinstance(v, dict):
                if k not in node:
                    dict.__setitem__(node, k, CfgNode())
                put(node[k], v)
            else:
                old = node.get(k)
                if isinstance(v, list) and (isinstance(old, tuple)
                                            or k in ("TRAIN", "VAL", "TEST")):
                    v = tuple(v)
                dict.__setitem__(node, k, v)

    c = defaults.clone()
    put(c, values)
    s = internal_seed(seed)
    c.RNG_SEED = s % 100003
    for d in (c.DATASET_SOURCE, c.DATASET_TARGET):
        sub = d.get(d.TYPE)
        if sub is not None and "seed" in sub:
            sub["seed"] = (s + int(sub["seed"])) % (2 ** 31 - 1)
    c.freeze()
    return c


def internal_seed(seed: int) -> int:
    """A whole number of any size as a seed for numpy, torch and the
    program: the same run seed gives the same seed."""
    return int(seed) % (2 ** 31 - 1)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Phases:
    """Host seconds of a run's named phases, for standard error."""

    def __init__(self):
        self.seconds = {}

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) \
                + time.perf_counter() - t0

    def line(self) -> str:
        return "phases_s " + " ".join("{}={:.2f}".format(k, v)
                                      for k, v in self.seconds.items())
