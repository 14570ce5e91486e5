"""Data parallelism in the loader and in ``train()`` on the CPU over gloo
(the step itself is held to JAX's ``shard_map`` in
``test_torch_data_parallel.py``, whose worker processes this file uses).

* The loader's per-rank block: rank r of n loads the r-th contiguous block
  of every sampled batch, the samples JAX's shard r steps on.
* ``train()`` in 2 gloo processes on ``mopa_smoke.yaml`` (cut as
  ``test_torch_driver.py`` cuts it, ``TPU.DATA_PARALLEL`` 2) for 3
  iterations across the EMA switch (2), checkpoints at 2 and 3, validation
  at 3: the replicas equal bit for bit; rank 0 alone writing checkpoints
  and the IoU table, the other rank returning no ``eval_dict``; rank 0's
  validation equal (confusion matrices) to one process's ``validate()`` on
  the checkpoint it wrote, whose weights equal the replicas'.
"""

import os

import numpy as np
import torch

from mopa_tpu_torch.common.config import CfgNode
from mopa_tpu_torch.parallel import mesh as mesh_mod
from mopa_tpu_torch.train import trainer as port_trainer
from test_torch_data_parallel import (WORLD, _assert_states_equal, _plain,
                                      _state_digest, run_workers)

torch.set_num_threads(1)


# -- the loader's block ------------------------------------------------------

def test_loader_takes_the_rank_block(monkeypatch):
    """Rank r of n loads the r-th contiguous block of every sampled batch,
    the samples JAX's shard r steps on; without a mesh the whole batch."""
    from mopa_tpu_torch.data import build

    monkeypatch.setattr(build, "collate_padded",
                        lambda samples, *a, **k: samples)

    class Ids:
        def __getitem__(self, i):
            return int(i)

    sampled = [np.asarray([7, 3, 9, 1, 4, 0]), np.asarray([2, 8, 5, 6, 11,
                                                           10])]
    for n in (1, 2, 3):
        for r in range(n):
            mesh = mesh_mod.DataMesh(group=None, size=n, rank=r,
                                     backend="gloo")
            loader = build.DataLoader(Ids(), sampled, 16, mesh=mesh)
            want = [list(b[r * 6 // n:(r + 1) * 6 // n]) for b in sampled]
            assert list(loader) == want
    assert list(build.DataLoader(Ids(), sampled, 16)) == \
        [list(b) for b in sampled]


# -- train() in two processes ------------------------------------------------

def test_train_two_ranks(tmp_path):
    """3 iterations across the EMA switch (2) with checkpoints at 2 and 3
    and validation at 3."""
    from test_torch_data_path import smoke_cfgs
    from test_torch_driver import OPTS

    from mopa_tpu_torch.common.metric_logger import MetricLogger
    from mopa_tpu_torch.data.build import build_dataloader
    from mopa_tpu_torch.data.utils.validate import validate

    _, pcfg = smoke_cfgs(**dict(OPTS, **{"TPU.DATA_PARALLEL": WORLD,
                                         "SCHEDULER.MAX_ITERATION": 3}))
    out_dir = tmp_path / "run"
    out_dir.mkdir()
    ranks = run_workers(tmp_path, {"kind": "train", "cfg": _plain(pcfg),
                                   "out_dir": str(out_dir)})
    _assert_states_equal(ranks[1]["state"], ranks[0]["state"], "replicas")
    assert ranks[0]["step"] == 3
    assert ranks[1]["saves"] == [] and ranks[1]["xlsx"] == []
    assert ranks[1]["eval"] == {}
    saved = {os.path.basename(f) for f in ranks[0]["saves"]}
    assert saved == {"model_{}_{:06d}.pth".format(s, i) for s in ("2d", "3d")
                     for i in (2, 3)} | {
        "best_val_{}_{}.pth".format(m, s) for m, s in
        (("2d", "2d"), ("3d", "3d"), ("xM", "2d"), ("xM", "3d"))}
    assert {p.name for p in out_dir.glob("*.pth")} <= saved
    assert len(ranks[0]["xlsx"]) == 1

    # one process validates the weights rank 0 saved at the end
    cfg = CfgNode(_plain(pcfg))
    cfg.TPU.DATA_PARALLEL = 1
    models = port_trainer.build_models(cfg, device="cpu")
    state = port_trainer.create_train_state(cfg, models)
    for which in ("2d", "3d"):
        ckpt = torch.load(out_dir / "model_{}_000003.pth".format(which),
                          weights_only=False)
        port_trainer.CheckpointAdapter(which, models, state).load_state_dict(
            ckpt)
    _assert_states_equal({k: v for k, v in _state_digest(state).items()
                          if not k.startswith(("opt_", "rng"))},
                         {k: v for k, v in ranks[0]["state"].items()
                          if not k.startswith(("opt_", "rng"))}, "loaded")
    eval_dict = validate(cfg, models, build_dataloader(cfg, "val", "target"),
                         MetricLogger(), _quiet())
    want = {k: v.confusion_matrix.tolist() for k, v in eval_dict.items()}
    assert ranks[0]["eval"] == want


def _quiet():
    import logging

    log = logging.getLogger("test_torch_data_parallel.one")
    log.setLevel(logging.WARNING)
    return log
