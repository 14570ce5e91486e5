"""What a run loads: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``mopa_tpu`` (the JAX package; ``mopa_tpu_torch`` is another
name, compared whole), and the check that finds one."""

import subprocess
import sys

from benchmark.harness import core


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, {root!r});"
        "from benchmark.harness import core, runner;"
        "from benchmark.tests.bench_small import small_driver;"
        "d = small_driver('mopa_scn.train_prebuilt', 1); d.setup();"
        "d.window(0.1); d.release(); d.check();"
        "import mopa_tpu_torch.data.utils.validate;"
        "print(core.forbidden_modules());"
        "sys.exit(1 if core.forbidden_modules() else 0)").format(
            root=str(core.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def test_the_check_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mopa_tpu_torch_extra", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mopa_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert core.forbidden_modules() == ["jaxlib", "mopa_tpu"]
