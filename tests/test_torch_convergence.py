"""The port's convergence gate (``mopa_tpu_torch.tools.convergence_check``)
against ``tools/convergence_check.py``.

* The config the port trains equals the one JAX's ``main()`` hands its
  ``train()`` (captured by a stub), key by key, apart from the TPU-only keys
  the port leaves out (``tests/test_torch_config.py``), at the default 500
  iterations and at 3,000; the gate constants are equal.
* A 3-iteration run on the CPU (the EMA switch at iteration 2) prints the
  JSON line and exits 1: the gate fails.
* With ``train()`` stubbed to return evaluators at given mIoUs: exit 0
  when all three clear their gates, 1 when one is just below.
"""

import importlib.util
import json
import os
import types

import pytest
import torch

from mopa_tpu_torch.tools import convergence_check as port_cc
from test_torch_config import JAX_ONLY, PORT_ONLY, _flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cc():
    spec = importlib.util.spec_from_file_location(
        "jax_convergence_check",
        os.path.join(ROOT, "tools", "convergence_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gate_constants_equal():
    jax_cc = _jax_cc()
    assert (port_cc.GATE_2D, port_cc.GATE_3D, port_cc.GATE_XM) == (
        jax_cc.GATE_2D, jax_cc.GATE_3D, jax_cc.GATE_XM) == (0.70, 0.50, 0.70)


@pytest.mark.parametrize("iters", [None, 3000])
def test_config_equals_jax(monkeypatch, iters):
    from mopa_tpu.common import cache
    from mopa_tpu.train import common as jax_common

    if iters is None:
        monkeypatch.delenv("CONV_ITERS", raising=False)
    else:
        monkeypatch.setenv("CONV_ITERS", str(iters))
    seen = []
    monkeypatch.setattr(cache, "enable_compile_cache", lambda: None)
    monkeypatch.setattr(jax_common, "train",
                        lambda cfg, *a, **kw: seen.append(cfg) or (None, {}))
    with pytest.raises(SystemExit):
        _jax_cc().main()
    (want,) = seen
    got = port_cc.convergence_cfg(iters or 500)
    assert got.is_frozen()
    want_flat = {k: v for k, v in _flat(want).items() if k not in JAX_ONLY}
    assert {k: v for k, v in _flat(got).items()
            if not k.startswith(PORT_ONLY)} == want_flat
    assert got.SCHEDULER.MAX_ITERATION == (iters or 500)


def test_three_iterations_on_cpu_fail_the_gate(capsys):
    torch.set_num_threads(1)
    with pytest.raises(SystemExit) as exc:
        port_cc.main(["--iters", "3"], device="cpu")
    assert exc.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["iters"] == 3 and line["pass"] is False
    assert set(line["miou"]) == {"2D", "3D", "2D+3D"}
    assert line["gate"] == {"2D": 0.70, "3D": 0.50, "2D+3D": 0.70}
    assert all(0.0 <= v <= 1.0 for v in line["miou"].values())


@pytest.mark.parametrize("ious,code", [
    ((0.71, 0.51, 0.71), 0), ((0.70, 0.50, 0.70), 0),
    ((0.71, 0.49, 0.71), 1), ((0.69, 0.51, 0.71), 1),
    ((0.71, 0.51, 0.69), 1)])
def test_gate_decides_the_exit_code(monkeypatch, capsys, ious, code):
    from mopa_tpu_torch.train import common

    evals = {k: types.SimpleNamespace(overall_iou=v)
             for k, v in zip(("2D", "3D", "2D+3D"), ious)}
    monkeypatch.setattr(common, "train",
                        lambda cfg, *a, **kw: (None, evals))
    with pytest.raises(SystemExit) as exc:
        port_cc.main(["--iters", "10"], device="cpu")
    assert exc.value.code == code
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["pass"] is (code == 0)
    assert line["miou"] == dict(zip(("2D", "3D", "2D+3D"), ious))
