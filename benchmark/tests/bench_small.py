"""A cell's configuration and traffic at a size the CPU runs in seconds:
2 + 2 scans of 1,024 points from 2,048-point raw scans, 128 x 96 images,
the 3D net at its module's ``small`` values, float32 unless asked (the CPU
has no bfloat16 convolution fast enough), capacities of the whole budget
at every level."""

import copy

from benchmark.harness import core
from benchmark.reference import nets3d


def files(name: str) -> tuple:
    """(configuration file, traffic file) of cell ``name`` (its
    configuration is the name's part before the first dot)."""
    traffic = core.load_json(core.BENCH_DIR / "workloads" / (name + ".json"))
    conf = core.load_json(core.BENCH_DIR / "configs"
                          / (name.split(".")[0] + ".json"))
    return conf, traffic


def small_cfg(name: str, dtype: str = "float32") -> dict:
    c = copy.deepcopy(files(name)[0]["cfg"])
    c["TRAIN"]["BATCH_SIZE"] = 2
    c["TPU"].update({"POINT_BUDGET": 1024, "COMPUTE_DTYPE": dtype,
                     "SAM_MASK_BUDGET": 16, "CAP_FACTORS": [1.0] * 7})
    for d in ("DATASET_SOURCE", "DATASET_TARGET"):
        c[d]["SyntheticSCN"].update({"n_points": 2048, "length": 16,
                                     "image_size": [128, 96]})
    net, sub = nets3d.of(c["MODEL_3D"])
    c["MODEL_3D"][c["MODEL_3D"]["TYPE"]] = net.small(sub)
    return c


SMALL_TRAFFIC = {"pool": 4, "trace_steps": 2}


def small_driver(name: str, seed: int, dtype: str = "float32",
                 device="cpu"):
    conf, traffic = files(name)
    conf = dict(conf, cfg=small_cfg(name, dtype))
    traffic = dict(traffic, **SMALL_TRAFFIC)
    return core.driver(traffic).Driver(conf, traffic, seed, device)


def card_cfg(name: str) -> dict:
    """The configuration at its own widths, depth and dtype, with 2 + 2
    scans of 4,096 points: a size a test run on the card holds."""
    c = copy.deepcopy(files(name)[0]["cfg"])
    c["TRAIN"]["BATCH_SIZE"] = 2
    c["TPU"].update({"POINT_BUDGET": 4096, "CAP_FACTORS": [1.0] * 7})
    for d in ("DATASET_SOURCE", "DATASET_TARGET"):
        c[d]["SyntheticSCN"].update({"n_points": 6000, "length": 16})
    return c


def card_driver(name: str, seed: int):
    conf, traffic = files(name)
    conf = dict(conf, cfg=card_cfg(name))
    traffic = dict(traffic, **SMALL_TRAFFIC)
    return core.driver(traffic).Driver(conf, traffic, seed, "cuda")
