"""The port's capacity audit and SemanticKITTI preprocess
(``mopa_tpu_torch.data.capacity_audit``, ``data.semantic_kitti.preprocess``)
against ``mopa_tpu``'s.

* ``coords_occupancy`` / ``scan_occupancy`` equal, and ``SplitAuditor``'s
  JSON file byte-equal (with and without a projected overflow, and with no
  scan).
* The preprocess of ``make_fake_kitti``'s scenes of the train and val
  splits (one frame each) through each package's CLI entry point, with the
  ground indices and the audit of every scan: ``<split>.pkl`` and
  ``capacity_audit_<split>.json`` byte-equal. The ``g_indices/<scene>/
  <frame>.bin`` files are byte-equal when the port's plane fits use JAX's
  3x3 ``eigh`` (patched in); with torch's own the ground masks agree on
  >= 0.999 of the points: the two LAPACK builds round the covariances'
  eigenvectors differently, which moves points that lie on a threshold of
  these uniform random scans (3 of ~3,700 ground indices, in one of the 10
  scans).
"""

import os
import os.path as osp
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.data import capacity_audit as jax_audit
from mopa_tpu.data.semantic_kitti import preprocess as jax_pre
from mopa_tpu_torch.data import capacity_audit
from mopa_tpu_torch.data.semantic_kitti import preprocess
from mopa_tpu_torch.data.semantic_kitti import splits as split_defs
from test_datasets_real_format import make_fake_kitti


def _scan(seed, n=30000):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(4, 50 ** 2, n))
    th = rng.uniform(-0.8, 0.8, n)
    return np.stack([r * np.cos(th), r * np.sin(th),
                     rng.uniform(-1.8, 2.0, n)], 1).astype(np.float32)


@pytest.mark.parametrize("budget", [4096, 16384])
def test_occupancy_matches_jax(budget):
    pts = _scan(0)
    kw = dict(point_budget=budget, num_levels=7)
    np.testing.assert_array_equal(
        capacity_audit.scan_occupancy(pts, **kw),
        jax_audit.scan_occupancy(pts, **kw))
    coords = np.random.default_rng(1).integers(0, 300, (20000, 3))
    np.testing.assert_array_equal(
        capacity_audit.coords_occupancy(coords, cap_factors=(0.5, 0.3), **kw),
        jax_audit.coords_occupancy(coords, cap_factors=(0.5, 0.3), **kw))


@pytest.mark.parametrize("case", ["fits", "overflows", "empty"])
def test_split_auditor_json_equal(tmp_path, case):
    # uniform scans dedup less than LiDAR: the built-in schedule overflows
    kw = {"fits": {"cap_factors": (1.0,) * 7}, "overflows": {},
          "empty": {}}[case]
    files, printed = [], []
    for mod, name in ((jax_audit, "jax"), (capacity_audit, "port")):
        auditor = mod.SplitAuditor("train", scale=20, full_scale=4096, **kw)
        for seed in range(3 if case != "empty" else 0):
            auditor.add(_scan(seed))
        path = str(tmp_path / "{}.json".format(name))
        rep = auditor.save(path, print_fn=printed.append)
        files.append(open(path, "rb").read())
        assert rep.get("projected_overflow", False) == (case == "overflows")
    assert files[0] == files[1]
    assert printed[0] == printed[1].replace("port.json", "jax.json")


def _outputs(root, out_dir):
    """{relative path: bytes} of what a preprocess wrote."""
    got = {}
    for base in (out_dir, osp.join(root, "g_indices")):
        for dirpath, _, names in os.walk(base):
            for n in names:
                p = osp.join(dirpath, n)
                got[osp.relpath(p, root)] = open(p, "rb").read()
    return got


def test_semantic_kitti_preprocess_files_equal(tmp_path, monkeypatch):
    scenes = tuple(split_defs.train) + tuple(split_defs.val)
    root = make_fake_kitti(str(tmp_path / "kitti"), scenes=scenes, frames=1,
                           n_points=3000, with_extras=False)
    out_dir = osp.join(root, "preprocess")
    args = ["--root_dir", root, "--splits", "train", "val", "--ground",
            "--audit-stride", "1"]
    monkeypatch.setattr(sys, "argv", ["preprocess"] + args)
    jax_pre.main()
    want = _outputs(root, out_dir)

    def jax_eigh(cov):
        evals, evecs = jnp.linalg.eigh(jnp.asarray(cov.numpy()))
        return (torch.from_numpy(np.array(evals)),
                torch.from_numpy(np.array(evecs)))

    runs = {}
    for name in ("jax_eigh", "torch_eigh"):
        shutil.rmtree(out_dir)
        shutil.rmtree(osp.join(root, "g_indices"))
        with monkeypatch.context() as m:
            if name == "jax_eigh":
                m.setattr(torch.linalg, "eigh", jax_eigh)
            preprocess.main(args, device="cpu")
        runs[name] = _outputs(root, out_dir)
    for got in runs.values():
        assert sorted(got) == sorted(want)
    assert {"preprocess/train.pkl", "preprocess/val.pkl",
            "preprocess/capacity_audit_train.json",
            "g_indices/00/000000.bin", "g_indices/07/000000.bin"} <= set(want)
    differ = points = 0
    for k in want:
        assert runs["jax_eigh"][k] == want[k], k
        if not k.startswith("g_indices"):
            assert runs["torch_eigh"][k] == want[k], k
            continue
        a = set(np.frombuffer(want[k], np.int32).tolist())
        b = set(np.frombuffer(runs["torch_eigh"][k], np.int32).tolist())
        assert 0 < len(a) < 3000
        differ += len(a ^ b)
        points += 3000
    # the ground masks of the split's scans agree on >= 0.999 of the points
    assert differ <= 0.001 * points, (differ, points)
