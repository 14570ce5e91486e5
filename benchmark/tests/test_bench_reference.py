"""The reference against the program at a small size on the CPU, in float32,
where the two differ by rounding alone: each cell's check drives the
program and the reference over the same seeded inputs and weights."""

import numpy as np
import pytest
import torch

from benchmark.harness import train
from benchmark.reference import model as ref
from benchmark.tests.bench_small import files, small_driver


@pytest.mark.parametrize("name", ["mopa_scn.train_prebuilt",
                                  "spvcnn.train_prebuilt"])
def test_train_step_matches_the_program(name):
    drv = small_driver(name, seed=3)
    drv.setup()
    drv.release()
    nums = drv.check()["program"]
    # float32 on both sides: the losses agree to rounding, the worst
    # leaf's first gradient to a few 1e-4 of the median leaf's (sums of
    # opposite terms, taken in other orders), the changes after three
    # Adam steps to a few % (elements whose gradient is near zero flip)
    assert nums["loss_gap"] < 1e-4
    assert nums["grad_gap"] < 5e-3
    assert nums["change_gap"] < 0.1
    # SPVCNN's decoder blocks worked out again from the program's inputs
    assert ("decoder_gap" in nums) is name.startswith("spvcnn.")
    assert nums.get("decoder_gap", 0.0) < 1e-5


def test_decoder_control_fails_the_cells_limit():
    """The reference's decoder blocks in TF32 in the program's place read
    above the cell's own limit, through the harness's judgement."""
    from benchmark.harness.runner import judge

    name = "spvcnn.train_prebuilt"
    drv = small_driver(name, seed=5)
    drv.setup()
    drv.release()
    nums = drv.check(control=True)
    limits = files(name)[1]["limits"]
    assert judge(nums["program"], limits)[1], nums["program"]
    one = {"decoder_gap": nums["control"]["decoder_gap"]}
    assert not judge(one, {"decoder_gap": limits["decoder_gap"]})[1], nums


def test_reference_plan_matches_the_programs_device_plan():
    from mopa_tpu_torch.models.scn_unet import build_unet_plan_batched

    rng = np.random.default_rng(0)
    coords = torch.from_numpy(rng.integers(0, 40, (2, 300, 3)))
    valid = torch.ones(2, 300, dtype=torch.bool)
    valid[1, 250:] = False
    prog = build_unet_plan_batched(coords, valid, 4, capacities=[600] * 4,
                                   sample_domains=[0, 1])
    mine = ref.scans_plan([(coords[0], valid[0], 1, 0),
                           (coords[1], valid[1], 1, 1)], 4)
    for lv_p, lv_r, n in zip(prog.levels, mine.levels, prog.num_voxels):
        assert int(n) == lv_r.key.shape[0]
        assert int(lv_p.valid.sum()) == lv_r.key.shape[0]
        assert int(lv_p.dom[lv_p.valid].sum()) == int(lv_r.dom.sum())


def test_reference_imports_nothing_of_the_program(tmp_path):
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, {!r});"
            "import benchmark.reference.model, benchmark.harness.counts;"
            "import benchmark.reference.nets3d as n;"
            "got = sorted(m.__name__.rsplit('.', 1)[1] for m in n.modules());"
            "assert {{'scn', 'spvcnn'}} <= set(got), got;"
            "bad = sorted({{m.split('.')[0] for m in sys.modules}}"
            " & {{'mopa_tpu_torch', 'mopa_tpu', 'jax', 'flax'}});"
            "print(bad); sys.exit(1 if bad else 0)").format(
                str(train.__file__).rsplit("/benchmark/", 1)[0])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
