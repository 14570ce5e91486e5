"""``mopa_tpu_torch`` imports without JAX and without the JAX package.

A subprocess blocks ``jax``, ``flax``, ``optax`` and ``mopa_tpu`` (the exact
package name and its submodules, not the ``mopa_tpu_torch`` prefix) on
``sys.meta_path``, then imports the port and every one of its submodules.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "flax", "optax", "mopa_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import mopa_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(
        mopa_tpu_torch.__path__, "mopa_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print(len(names))
""")


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    # every module of the package was imported, the kernel wrapper included
    assert int(res.stdout.split()[-1]) >= 20, res.stdout
