"""The 3D nets as plug-ins: ``MODEL_3D.TYPE`` finds its module under
``benchmark/reference/nets3d/``; a toy net added at test time runs the
whole contract with no file of the benchmark edited; the two nets of the
benchmark draw the same weights and count the same work as before they
became modules; and ``sparse3d.neighbours`` maps any odd cube."""

import hashlib
import sys
from pathlib import Path

import pytest
import torch

from benchmark.drivers import prebuilt_train
from benchmark.harness import train
from benchmark.harness.runner import judge
from benchmark.reference import model as ref
from benchmark.reference import nets3d
from benchmark.reference import sparse3d as sp
from benchmark.tests.bench_small import files, small_cfg

TOY_DIR = Path(__file__).resolve().parent / "toy_nets3d"


def test_the_registry_finds_each_net_by_its_type():
    for kind, name in (("SCN", "scn"), ("SPVCNN", "spvcnn")):
        mod = nets3d.find(kind)
        assert mod.__name__ == "benchmark.reference.nets3d." + name
        for fn in ("build", "convs", "peak_s", "small"):
            assert callable(getattr(mod, fn)), (kind, fn)
    mod, sub = nets3d.of({"TYPE": "SCN", "SCN": {"m": 16}})
    assert mod.TYPE == "SCN" and sub == {"m": 16}
    assert nets3d.of({"TYPE": "SPVCNN"})[1] == {}


def test_an_unknown_net_names_the_file_to_add():
    with pytest.raises(ValueError, match="reference/nets3d/ptv3.py"):
        nets3d.find("PTv3")


# -- a net added as new files alone --------------------------------------

@pytest.fixture
def toy(monkeypatch):
    """The toy net of ``toy_nets3d/toy.py`` in the ``nets3d`` namespace."""
    monkeypatch.setattr(nets3d, "__path__",
                        list(nets3d.__path__) + [str(TOY_DIR)])
    monkeypatch.delitem(sys.modules, "benchmark.reference.nets3d.toy",
                        raising=False)
    yield nets3d.find("TOY")
    sys.modules.pop("benchmark.reference.nets3d.toy", None)


def toy_files() -> tuple:
    """The MoPA configuration's file with the toy as its 3D net at its
    small values, its control TF32 (the CPU sizes run in float32), and a
    traffic of two pre-built pairs with no VGI, with limits."""
    conf, traffic = files("mopa_scn.train_prebuilt")
    cfg = small_cfg("mopa_scn.train_prebuilt")
    cfg["MODEL_3D"] = {"TYPE": "TOY", "NUM_CLASSES": 10, "DUAL_HEAD": True,
                       "TOY": nets3d.find("TOY").small({"m": 8})}
    conf = dict(conf, name="toy", cfg=cfg, control="tf32")
    limits = dict(traffic["limits"], toy_gap=1e-6)
    traffic = dict(traffic, pool=2, with_mopa=False, limits=limits)
    return conf, traffic


def test_a_toy_net_runs_the_whole_contract(toy):
    conf, traffic = toy_files()
    cfg, seed = conf["cfg"], 11
    assert cfg["MODEL_3D"]["TOY"] == {"m": 4}

    # seeded weights, the same for the same seed, by the program's names
    p2d, p3d = train.reference_params(cfg, seed, "cpu")
    again = train.reference_params(cfg, seed, "cpu")[1]
    assert all(torch.equal(p3d[k], again[k]) for k in p3d)
    assert set(p3d) >= {"net_3d.stem", "net_3d.down", "net_3d.up",
                        "linear.weight", "linear2.weight"}
    assert p3d["net_3d.stem"].shape == (27, 1, 4)

    drv = prebuilt_train.Driver(conf, traffic, seed, "cpu")
    drv.raw = prebuilt_train.raw_pool(drv.cell.cfg, 2,
                                      train.seeds(seed)["data"])
    pairs = [(s, t, None) for s, t in drv.raw[:1]]

    # one reference step moves every leaf of the toy
    out = ref.train_readings(cfg, p2d, p3d, pairs,
                             train.seeds(seed)["dropout"], "cpu")
    assert len(out["losses"]) == 1 and out["losses"][0] > 0
    for k in ("3d.net_3d.stem", "3d.net_3d.down", "3d.net_3d.up"):
        assert float(out["grads"][k].norm()) > 0, k
        assert float(out["change"][k].norm()) > 0, k

    # its counts, and its own count summed over a window's steps
    per = [drv.cell.step_counts(s, t, None) for s, t in drv.raw]
    assert set(per[0]) == {"conv_least_s", "model_peak_s", "toy_voxels"}
    assert per[0]["conv_least_s"] > 0 and per[0]["model_peak_s"] > 0
    total = drv.work({"batches": [0, 1, 0]})
    assert total["toy_voxels"] == 2 * per[0]["toy_voxels"] \
        + per[1]["toy_voxels"]

    # its check number: the reference's toy stands in for the program's,
    # read by the toy's hooks, then judged against the traffic's limit
    cell = drv.cell
    stand_in = ref.build_net3d(cfg, "cpu")
    ref.load(stand_in, p3d)
    stand_in.train()
    hooks = toy.check_hooks(stand_in, cell.readings)
    feats, plan, nd = cell.net_input(pairs[0][0], pairs[0][1], 2)
    with torch.no_grad():
        stand_in(feats, plan, nd)
    for h in hooks:
        h.remove()
    cell.readings.update(cell.reference_readings(pairs))
    nums = train.check_numbers(cell, lambda: pairs, control=True)
    assert nums["program"]["toy_gap"] == 0.0
    assert judge(nums["program"], traffic["limits"])[1], nums
    assert not judge(nums["control"], traffic["limits"])[1], nums
    # the toy's own number separates the control by itself
    one = {"toy_gap": nums["control"]["toy_gap"]}
    assert not judge(one, {"toy_gap": traffic["limits"]["toy_gap"]})[1], nums
    cell.readings["toy"] = cell.readings["toy"] * (1 + 1e-3)
    nums = train.check_numbers(cell, lambda: pairs, control=False)
    assert not judge(nums["program"], traffic["limits"])[1], nums


# -- the benchmark's nets, as counted before they became modules ---------

def _sha(lines) -> str:
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


# at the CPU tests' sizes, seed 7, two pre-built pairs, a window of the
# steps [0, 1, 0]: read on the commit before the nets became modules
PINNED = {
    "mopa_scn.train_prebuilt": {
        "conv_least_s": 1.2418027462686566e-05,
        "model_peak_s": 0.0007724877408484848,
        "convs": "32a3aab59738351a",
        "2d": (142, "ac64a112682ca8f4", "9bb477ae7b360778"),
        "3d": (34, "16d63455b3df02aa", "d2de60d31e32915d")},
    "spvcnn.train_prebuilt": {
        "conv_least_s": 0.000573876413559838,
        "model_peak_s": 0.0012112791381333333,
        "convs": "1abd4bc885b646bd",
        "2d": (142, "ac64a112682ca8f4", "9bb477ae7b360778"),
        "3d": (163, "1a06c6e0166496f9", "772de3f749f0edf9")},
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_counts_and_weights_as_pinned(name):
    want, seed = PINNED[name], 7
    conf, traffic = files(name)
    conf = dict(conf, cfg=small_cfg(name))
    drv = prebuilt_train.Driver(conf, dict(traffic, pool=2), seed, "cpu")
    drv.raw = prebuilt_train.raw_pool(drv.cell.cfg, 2,
                                      train.seeds(seed)["data"])
    work = drv.work({"batches": [0, 1, 0]})
    assert work == {"conv_least_s": want["conv_least_s"],
                    "model_peak_s": want["model_peak_s"]}
    cell = drv.cell
    convs = cell.net.convs(cell.sub, ref.compute_dtype(conf["cfg"]))
    assert _sha([repr(convs)]) == want["convs"]
    for tag, params in zip(("2d", "3d"),
                           train.reference_params(conf["cfg"], seed, "cpu")):
        norms = ["{:.6e}".format(float(v.float().norm()))
                 for v in params.values()]
        assert (len(params), _sha(params), _sha(norms)) == want[tag], tag


# -- neighbour maps of any odd cube ----------------------------------------

def seeded_plan():
    g = torch.Generator().manual_seed(3)
    coords = torch.randint(0, 12, (400, 3), generator=g)
    sample = torch.randint(0, 2, (400,), generator=g)
    valid = torch.rand(400, generator=g) > 0.1
    return sp.build_plan(coords, sample, valid, torch.tensor([0, 1]), 2)


def test_neighbours_at_three_is_the_levels_map():
    for lv in seeded_plan().levels:
        assert torch.equal(sp.neighbours(lv, 3), lv.nbr)


def test_neighbours_at_five_by_brute_force():
    lv = seeded_plan().levels[0]
    got = sp.neighbours(lv, 5)
    sample = sp.unpack(lv.key)[0]
    where = {(int(s), *map(int, c)): i
             for i, (s, c) in enumerate(zip(sample, lv.coords))}
    offs = [(dx, dy, dz) for dx in range(-2, 3) for dy in range(-2, 3)
            for dz in range(-2, 3)]
    want = torch.tensor([[where.get((int(s), int(c[0]) + dx, int(c[1]) + dy,
                                     int(c[2]) + dz), -1)
                          for dx, dy, dz in offs]
                         for s, c in zip(sample, lv.coords)])
    assert got.shape == (lv.key.shape[0], 125)
    assert torch.equal(got, want)
    assert int((got >= 0).sum()) > int((lv.nbr >= 0).sum())
    with pytest.raises(ValueError):
        sp.neighbours(lv, 4)
