"""A run with the timed path broken underneath comes out not correct: the
whole run but the look for a card, at a small size on the CPU, against
each cell's own limits, once for every fault the cell can have (one chip:
no exchange between chips to leave out). The unbroken run comes out
correct."""

import pytest

from benchmark.harness import faults, runner
from benchmark.tests.bench_small import SMALL_TRAFFIC, small_cfg

TRAIN_CELLS = ["mopa_scn.train_prebuilt", "spvcnn.train_prebuilt"]


def run(name):
    result, _ = runner.run_cell(name, 21, 0.2, False, "cpu",
                                conf_cfg=small_cfg(name),
                                traffic_over=SMALL_TRAFFIC)
    return result


@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [None] + sorted(faults.TRAIN))
def test_train_cell_faults(name, fault):
    with faults.TRAIN[fault]() if fault else faults.unbroken():
        result = run(name)
    assert result["correct"] is (fault is None), result["compared"]

