"""The port's eval step against the JAX reference.

* ``make_eval_step`` at a small size (m=4, 3 planes, 2 scans of 256 points,
  a 32x48 image, 10 classes) against ``mopa_tpu``'s ``make_eval_step``:
  probabilities and losses to 1e-5. The scans are key-sorted because the
  reference's eval plan assumes sorted points (ROADMAP Queue 3); the port,
  which sorts for itself, gives the same outputs on shuffled scans.
* The golden scan at production depth (m=16, 7 planes) with the replica
  weights of ``tools/make_parity_golden.py``, imported through
  ``torch_compat.import_reference_2d/3d`` and the port's weight bridge, held
  to the bar of ``tests/test_parity_golden.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.config.xmuda import cfg as jax_base_cfg
from mopa_tpu.data.utils import validate as jax_validate
from mopa_tpu.models import torch_compat
from mopa_tpu.train import trainer as jax_trainer
from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
from mopa_tpu_torch.data.utils import validate as port_validate
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.train import trainer as port_trainer

torch.set_num_threads(1)

NCLS = 10
S, P, H, W = 2, 256, 32, 48


def _cfg(base, m, planes, n_points, full_scale=4096, cap_factors=()):
    c = base.clone()
    c.MODEL_2D.TYPE = "UNetResNet34"
    c.MODEL_3D.TYPE = "SCN"
    c.MODEL_2D.NUM_CLASSES = NCLS
    c.MODEL_3D.NUM_CLASSES = NCLS
    c.MODEL_2D.DUAL_HEAD = True
    c.MODEL_3D.DUAL_HEAD = True
    c.MODEL_2D.UNetResNet34.pretrained = False
    c.OPTIMIZER.MODEL_2D.TYPE = "Adam"
    c.OPTIMIZER.MODEL_3D.TYPE = "Adam"
    c.MODEL_3D.SCN.m = m
    c.MODEL_3D.SCN.num_planes = planes
    c.TPU.POINT_BUDGET = n_points
    c.MODEL_3D.SCN.full_scale = full_scale
    c.TPU.COMPUTE_DTYPE = "float32"
    c.TPU.CAP_FACTORS = tuple(cap_factors)
    return c


def _batch(seed):
    """Two key-sorted scans (duplicate voxels, padding last), wide dtypes."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((S, P, 3), np.int32)
    valid = np.zeros((S, P), bool)
    labels = np.full((S, P), -100, np.int32)
    for i, n in enumerate((P, 200)):
        c = rng.integers(0, 16, size=(n, 3)).astype(np.int32)
        key = (c[:, 0].astype(np.int64) * 4096 + c[:, 1]) * 4096 + c[:, 2]
        coords[i, :n] = c[np.argsort(key, kind="stable")]
        valid[i, :n] = True
        labels[i, :n] = rng.integers(-1, NCLS, n)  # -1: unlabeled points
    return {
        "img": rng.uniform(0, 1, (S, H, W, 3)).astype(np.float32),
        "img_indices": np.stack([rng.integers(0, H, (S, P)),
                                 rng.integers(0, W, (S, P))],
                                -1).astype(np.int32),
        "coords": coords.reshape(S * P, 3),
        "batch_idx": np.repeat(np.arange(S, dtype=np.int32), P),
        "feats": rng.normal(size=(S * P, 1)).astype(np.float32),
        "point_valid": valid,
        "seg_label": labels.reshape(S * P),
    }


def _perturb(stats, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(0, 0.1, v.shape) if k.endswith(".mean")
                else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
            for k, v in sorted(torch_compat.flatten_pytree(stats).items())}


@pytest.fixture(scope="module")
def reference():
    """JAX's eval step on key-sorted scans, and the port's models loaded with
    the same weights and perturbed batch statistics."""
    jcfg = _cfg(jax_base_cfg, 4, 3, P)
    pcfg = _cfg(port_base_cfg, 4, 3, P)
    batch = _batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    jmodels, _ = jax_trainer.build_models(jcfg)
    plan = jax_trainer.build_plan_from_batch(
        jcfg, jb["coords"], jb["batch_idx"], jb["point_valid"].reshape(-1),
        sample_size=P)
    v2d = jmodels.model_2d.init(jax.random.PRNGKey(0), jb["img"],
                                jb["img_indices"], jb["point_valid"])
    v3d = jmodels.model_3d.init(jax.random.PRNGKey(1), jb["feats"], plan)
    s2d, s3d = _perturb(v2d["batch_stats"], 2), _perturb(v3d["batch_stats"], 3)
    unflat = torch_compat.unflatten_into
    state = jax_trainer.TrainState(
        params_2d=v2d["params"],
        batch_stats_2d=unflat(v2d["batch_stats"], s2d), opt_2d=None,
        params_3d=v3d["params"],
        batch_stats_3d=unflat(v3d["batch_stats"], s3d), opt_3d=None,
        ema_params_2d=None, ema_params_3d=None, step=jnp.zeros((), jnp.int32),
        rng=None)
    want = jax_validate.make_eval_step(jcfg, jmodels)(state, jb)

    pmodels = port_trainer.build_models(pcfg, device="cpu")
    weights.load_flax_params(
        pmodels.model_2d, pmodels.model_3d,
        torch_compat.flatten_pytree(v2d["params"]), s2d,
        torch_compat.flatten_pytree(v3d["params"]), s3d)
    step = port_validate.make_eval_step(pcfg, pmodels)
    return batch, [np.asarray(w) for w in want], step


def test_eval_step_matches_jax(reference):
    batch, want, step = reference
    got = step(batch)
    names = ("probs_2d", "probs_3d", "seg_loss_2d", "seg_loss_3d")
    for name, g, w in zip(names, got, want):
        assert g.device.type == "cpu" and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_eval_step_on_shuffled_scans(reference):
    """The port sorts for itself: shuffling each scan's points (padding
    included) permutes the outputs and changes nothing else."""
    batch, want, step = reference
    rng = np.random.default_rng(9)
    perm = np.concatenate([i * P + rng.permutation(P) for i in range(S)])
    shuffled = dict(batch)
    for k in ("coords", "feats", "seg_label"):
        shuffled[k] = batch[k][perm]
    for k in ("img_indices", "point_valid"):
        flat = batch[k].reshape((S * P,) + batch[k].shape[2:])[perm]
        shuffled[k] = flat.reshape(batch[k].shape)
    got = step(shuffled)
    for name, g, w in zip(("probs_2d", "probs_3d"), got, want):
        np.testing.assert_allclose(g.numpy(), w[perm], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    for name, g, w in zip(("seg_loss_2d", "seg_loss_3d"), got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_golden_scan_production_depth():
    tools = os.path.join(os.path.dirname(__file__), "..", "tools")
    sys.path.insert(0, tools)
    import make_parity_golden as gen

    golden = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                  "parity_scan.npz"))
    _, sd2d, sd3d, _ = gen.build_replicas()
    n = int(golden["coords"].shape[0])
    budget = ((n + 127) // 128) * 128
    cfg = _cfg(port_base_cfg, gen.M, gen.NUM_PLANES, budget,
               full_scale=gen.SCALE, cap_factors=(1.0,) * gen.NUM_PLANES)
    models = port_trainer.build_models(cfg, device="cpu")
    p2d, s2d = torch_compat.import_reference_2d(sd2d, dual_head=True)
    p3d, s3d = torch_compat.import_reference_3d(
        sd3d, m=gen.M, num_planes=gen.NUM_PLANES, dual_head=True)
    weights.load_flax_params(models.model_2d, models.model_3d, p2d, s2d,
                             p3d, s3d)

    def pad(a):
        out = np.zeros((budget,) + a.shape[1:], a.dtype)
        out[:n] = a
        return out

    valid = torch.from_numpy(np.arange(budget) < n)
    coords = torch.from_numpy(pad(np.asarray(golden["coords"], np.int64)))
    with torch.no_grad():
        out2d = models.model_2d.eval()(
            torch.from_numpy(golden["img"][None]),
            torch.from_numpy(pad(golden["img_indices"])[None]), valid[None])
        plan = port_trainer.build_plan_from_batch(cfg, coords, valid, budget)
        out3d = models.model_3d.eval()(
            torch.from_numpy(pad(golden["feats"])), plan)
    for name, out in (("2d", out2d), ("3d", out3d)):
        ours = out["seg_logit"][:n].numpy()
        ref = np.asarray(golden["ref_logit_" + name], np.float32)
        agree = (ours.argmax(-1) == ref.argmax(-1)).mean()
        assert np.abs(ours - ref).max() < 5e-3, name
        assert agree > (0.999 if name == "2d" else 0.995), (name, agree)
