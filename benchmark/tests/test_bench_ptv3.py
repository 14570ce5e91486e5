"""Point Transformer V3 joins the benchmark as new files alone: the registry
finds ``reference/nets3d/ptv3.py`` by ``MODEL_3D.TYPE``, the file imports
nothing of the program, and its cell at a small size on the CPU agrees
with the program to rounding, carries its own counts to ``Driver.work``,
is failed by its control, and comes out not correct under every fault the
cell can have."""

import subprocess
import sys

import pytest
import torch

from benchmark.harness import core, faults, runner, train
from benchmark.harness.runner import judge
from benchmark.reference import nets3d
from benchmark.tests.bench_small import (SMALL_TRAFFIC, files, small_cfg,
                                         small_driver)

NAME = "ptv3.train_prebuilt"


def test_the_registry_finds_ptv3():
    mod = nets3d.find("PTv3")
    assert mod.__name__ == "benchmark.reference.nets3d.ptv3"
    for fn in ("build", "convs", "peak_s", "small", "work", "check_hooks",
               "check_gaps"):
        assert callable(getattr(mod, fn)), fn
    assert nets3d.of(files(NAME)[0]["cfg"]["MODEL_3D"])[0] is mod


def test_ptv3_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {!r});"
            "import benchmark.reference.nets3d.ptv3;"
            "bad = sorted({{m.split('.')[0] for m in sys.modules}}"
            " & {{'mopa_tpu_torch', 'mopa_tpu', 'jax', 'flax'}});"
            "print(bad); sys.exit(1 if bad else 0)").format(
                str(train.__file__).rsplit("/benchmark/", 1)[0])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_train_step_matches_the_program():
    drv = small_driver(NAME, seed=3)
    drv.setup()
    drv.release()
    nums = drv.check()["program"]
    # float32 on both sides, as the other cells' check at this size
    assert nums["loss_gap"] < 1e-4
    assert nums["grad_gap"] < 5e-3
    assert nums["change_gap"] < 0.1
    # the layouts equal, the encoder blocks worked out again
    assert nums["serial_gap"] == 0.0
    assert nums["block_gap"] < 1e-5


def test_ptv3_contract_on_the_cpu(monkeypatch):
    """The net's own counts reach ``Driver.work``'s window sums and the
    readers, its serialization equals the reference's, and the control
    (the reference's GEMM operands in float8, here on the CPU's float32)
    fails the cell's limits, ``block_gap`` among them."""
    drv = small_driver(NAME, seed=8)
    drv.setup()
    drv.window(0.1)
    drv.release()
    work = drv.work({"batches": [0, 1, 0]})
    assert {"conv_least_s", "model_peak_s", "ptv3_attn_least_s",
            "ptv3_attn_tokens", "ptv3_short_scans"} <= set(work)
    one = drv.cell.step_counts(*drv.raw[0], None)
    assert work["ptv3_attn_tokens"] == pytest.approx(
        2 * one["ptv3_attn_tokens"] + drv.cell.step_counts(
            *drv.raw[1], None)["ptv3_attn_tokens"])
    assert work["ptv3_attn_least_s"] > 0
    fill = core.reader("attn_fill.step").read(
        {"trace": None, "info": {"steps": 1}, "work": {}})
    assert fill is None
    monkeypatch.setitem(train.CONTROLS, "fp8", {torch.bfloat16: train._fp8,
                                                torch.float32: train._fp8})
    nums = drv.check(control=True)
    limits = files(NAME)[1]["limits"]
    assert nums["program"]["serial_gap"] == 0.0
    assert judge(nums["program"], limits)[1], nums["program"]
    assert not judge(nums["control"], limits)[1], nums["control"]
    one = {"block_gap": nums["control"]["block_gap"]}
    assert not judge(one, {"block_gap": limits["block_gap"]})[1], nums


@pytest.mark.parametrize("fault", [None] + sorted(faults.TRAIN))
def test_ptv3_cell_faults(fault):
    with faults.TRAIN[fault]() if fault else faults.unbroken():
        result, _ = runner.run_cell(NAME, 21, 0.2, False, "cpu",
                                    conf_cfg=small_cfg(NAME),
                                    traffic_over=SMALL_TRAFFIC)
    assert result["correct"] is (fault is None), result["compared"]
