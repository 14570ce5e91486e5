"""The port's config tree (``mopa_tpu_torch.config``) against the JAX package's:
every shipped experiment YAML merges into both and gives the same values,
apart from the TPU-only keys the port leaves out."""

import glob
import os

import pytest

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
YAMLS = sorted(glob.glob(os.path.join(CONFIG_DIR, "**", "*.yaml"),
                         recursive=True))
# TPU knobs of the JAX package that nothing in the port reads and no shipped
# YAML sets.
JAX_ONLY = {"TPU.PALLAS_CONV", "TPU.VOXEL_BUDGET", "TPU.VGI_CENTER_BUDGET"}


def _flat(node, prefix=""):
    out = {}
    for k, v in node.items():
        name = prefix + k
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


def test_shipped_yamls_found():
    assert len(YAMLS) >= 15


@pytest.mark.parametrize("path", YAMLS,
                         ids=[os.path.relpath(p, CONFIG_DIR) for p in YAMLS])
def test_shipped_yaml_merges_like_jax(path):
    from mopa_tpu.config.xmuda import cfg as jax_cfg
    from mopa_tpu_torch.config.xmuda import cfg as port_cfg

    want, got = jax_cfg.clone(), port_cfg.clone()
    want.merge_from_file(path)
    got.merge_from_file(path)
    want_flat = {k: v for k, v in _flat(want).items() if k not in JAX_ONLY}
    assert _flat(got) == want_flat
