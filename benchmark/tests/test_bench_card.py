"""On the card: each cell's control (the reference computed in the next
lower precision than the configuration states) reads at least three times
what the program reads on one of the cell's numbers, at the
configuration's widths with fewer and smaller scans; SPVCNN's float32
decoder, read by itself (``decoder_gap``), does so in TF32 alone. The
full-size readings that set the limits, and the controls judged against
them, come from ``benchmark/calibrate.py``."""

import pytest

from benchmark.harness import core
from benchmark.tests.bench_small import card_driver

CELLS = [w["name"] for w in core.registry()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_control_separates_from_the_program(card, name, seed):
    drv = card_driver(name, seed)
    drv.setup()
    if hasattr(drv, "window"):
        drv.window(0.5)
    drv.release()
    nums = drv.check(control=True)
    ratios = {k: nums["control"][k] / max(v, 1e-12)
              for k, v in nums["program"].items()}
    assert max(ratios.values()) >= 3.0, nums
    # SPVCNN's float32 decoder computed in TF32 shows by itself
    if "decoder_gap" in ratios:
        assert ratios["decoder_gap"] >= 3.0, nums
