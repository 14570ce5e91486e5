"""Data parallelism (``mopa_tpu_torch.parallel.mesh``) against the JAX
package's ``shard_map``-ed step, on the CPU over gloo.

* ``make_data_mesh`` / ``initialize_distributed``: None for one process or
  ``TPU.DATA_PARALLEL`` <= 1, an error for more ranks than the group has
  or no group at all; torchrun's environment initialises a gloo group, its
  absence is a no-op, a bad one raises; ``shard_range`` gives contiguous
  blocks as ``P("data")`` does.
* A world-1 gloo group steps bit for bit as ``mesh=None`` (two Adam steps:
  metrics, parameters, batch-norm buffers, EMA, optimizer moments and the
  generator's state), with 6 collectives a step.
* The port's step in 2 gloo processes against JAX's ``make_train_step(mesh=
  jax.make_mesh((2,), ("data",)))`` on the 8-device CPU mesh of
  ``conftest.py``: the fixtures of ``test_torch_train_step.py`` /
  ``test_torch_ema_step.py`` (the same flax weights through the bridge,
  dropout neutralised, SGD at lr 1000), the same global batch, each rank
  taking the block JAX's shard r takes; a pre-EMA step and an EMA step
  (``ema_xm_prob`` 1). Losses and metrics to 1e-5, integer metrics exact,
  batch statistics to 1e-5, every parameter's change to 1e-4 of its
  tensor's largest plus one float32 spacing of the parameter (the new
  value is a float32 number: the batch-norm biases sit at 2, where a
  spacing is 2.4e-7); the two ranks' states equal bit for bit (hashes of
  every tensor, the optimizers' state and the generator's).

The loader's per-rank block and ``train()`` over 2 ranks are in
``test_torch_data_parallel_train.py``. The processes run this file as a
script (``python tests/test_torch_data_parallel.py <job> <result>``), which
imports neither JAX nor the JAX package; the JAX side runs in the test
process.
"""

import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mopa_tpu_torch.common.config import CfgNode  # noqa: E402
from mopa_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from mopa_tpu_torch.train import trainer as port_trainer  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
WORKER_TIMEOUT_S = 300
_STATE = ("params_2d", "batch_stats_2d", "params_3d", "batch_stats_3d",
          "ema_params_2d", "ema_params_3d")


def _plain(cfg):
    """A config as nested plain dicts (picklable)."""
    return {k: _plain(v) if isinstance(v, dict) else v
            for k, v in cfg.items()}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _state_arrays(state) -> dict:
    """Every tensor of a train state as numpy, with the optimizers' moments,
    update counts and the generator's state."""
    out = {}
    for name in _STATE:
        for k, v in getattr(state, name).items():
            out[name + "/" + k] = v.detach().cpu().numpy().copy()
    for name in ("opt_2d", "opt_3d"):
        opt = getattr(state, name)
        for i, p in enumerate(opt.optimizer.param_groups[0]["params"]):
            for k, v in opt.optimizer.state.get(p, {}).items():
                out["{}/{}/{}".format(name, i, k)] = np.asarray(
                    v.detach().cpu() if torch.is_tensor(v) else v)
        out[name + "/count"] = np.asarray(opt.count)
    out["rng"] = state.rng.get_state().numpy()
    out["step"] = np.asarray(state.step)
    return out


def _state_digest(state) -> dict:
    """:func:`_state_arrays` with each array replaced by a hash of its
    bytes: equal digests are bit-equal states."""
    return {k: hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
            + str(v.dtype) + str(v.shape)
            for k, v in _state_arrays(state).items()}


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's block of every array of a global batch, split on the
    leading axis as ``P("data")`` splits it for JAX's device r (the port's
    loader loads that block itself, ``mesh.shard_range``)."""
    out = {}
    for k, v in batch.items():
        lo, hi = mesh_mod.shard_range(v.shape[0], mesh)
        out[k] = v[lo:hi]
    return out


def _assert_states_equal(a: dict, b: dict, tag: str) -> None:
    assert set(a) == set(b), tag
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=tag + " " + k)


# -- the worker processes ----------------------------------------------------

def _step_job(job, mesh):
    from mopa_tpu_torch.models import weights

    cfg = CfgNode(job["cfg"])
    out = []
    for mode, src, trg in job["steps"]:
        models = port_trainer.build_models(cfg, device="cpu")
        models.model_2d.net_2d.dropout_rate = 0.0
        state = port_trainer.create_train_state(
            cfg, models, flax_variables=job["flax"])
        step = port_trainer.make_train_step(cfg, models, with_pl=True,
                                            with_ema=mode == "ema",
                                            mesh=mesh)
        state, metrics = step(state, shard_batch(src, mesh),
                              shard_batch(trg, mesh))
        out.append({
            "metrics": {k: v.numpy() for k, v in metrics.items()},
            "state": _state_digest(state), "collectives": mesh.collectives})
        if mesh.rank == 0:  # the replicas' values, for the JAX comparison
            out[-1]["flax"] = {
                tag: weights.to_flax(net, tensors) for tag, net, tensors in (
                    ("params_2d", models.model_2d, state.params_2d),
                    ("params_3d", models.model_3d, state.params_3d),
                    ("stats_2d", models.model_2d, state.batch_stats_2d),
                    ("stats_3d", models.model_3d, state.batch_stats_3d))}
    return out


def _train_job(job, mesh):
    import logging

    from mopa_tpu_torch.train import common

    saves = []
    save = torch.save

    def counted(obj, f, *args, **kwargs):
        saves.append(str(f))
        return save(obj, f, *args, **kwargs)

    xlsx = []
    excel = common.iou_to_excel
    torch.save = counted
    common.iou_to_excel = lambda *a, **k: xlsx.append(a[1]) or excel(*a, **k)
    build = port_trainer.build_models

    def no_dropout(*args, **kwargs):
        models = build(*args, **kwargs)
        models.model_2d.net_2d.dropout_rate = 0.0
        return models

    port_trainer.build_models = no_dropout
    log = logging.getLogger("test_torch_data_parallel")
    log.setLevel(logging.WARNING)
    try:
        state, eval_dict = common.train(CfgNode(job["cfg"]), log,
                                        job["out_dir"], "run", "mopa",
                                        device="cpu")
    finally:
        torch.save = save
    return {"state": _state_digest(state), "step": state.step,
            "saves": saves, "xlsx": xlsx,
            "eval": {k: v.confusion_matrix.tolist()
                     for k, v in eval_dict.items()}}


def _worker(job_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    assert mesh_mod.initialize_distributed()
    mesh = mesh_mod.make_data_mesh(num_devices=WORLD)
    job = torch.load(job_path, weights_only=False)
    result = (_step_job if job["kind"] == "step" else _train_job)(job, mesh)
    torch.save(result, out_path)
    dist.destroy_process_group()


def run_workers(tmp_path, job: dict) -> list:
    """Run ``job`` in WORLD processes over gloo; each rank's result."""
    job_path = tmp_path / "job.pt"
    torch.save(job, job_path)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(WORLD),
               GLOO_SOCKET_IFNAME="lo", PYTHONPATH=ROOT)
    procs = []
    for r in range(WORLD):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(job_path),
             str(tmp_path / "rank{}.pt".format(r))],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, "rank {}:\n{}".format(r, log[-4000:])
    return [torch.load(tmp_path / "rank{}.pt".format(r), weights_only=False)
            for r in range(WORLD)]


# -- mesh semantics ----------------------------------------------------------

@pytest.fixture
def world1(tmp_path):
    """A one-process gloo group, destroyed afterwards."""
    dist.init_process_group("gloo", init_method="file://{}".format(
        tmp_path / "store"), rank=0, world_size=1)
    try:
        yield mesh_mod.data_mesh()
    finally:
        dist.destroy_process_group()


def _cfg_dp(n):
    from mopa_tpu_torch.config.xmuda import cfg

    c = cfg.clone()
    c.TPU.DATA_PARALLEL = n
    return c


def test_make_data_mesh_without_a_group():
    assert not dist.is_initialized()
    assert mesh_mod.make_data_mesh() is None
    assert mesh_mod.make_data_mesh(_cfg_dp(0)) is None
    assert mesh_mod.make_data_mesh(_cfg_dp(1)) is None
    assert mesh_mod.make_data_mesh(num_devices=1) is None
    for make in (lambda: mesh_mod.make_data_mesh(_cfg_dp(2)),
                 lambda: mesh_mod.make_data_mesh(num_devices=4)):
        with pytest.raises(RuntimeError, match="none is initialised"):
            make()


def test_make_data_mesh_in_a_group(world1):
    assert world1.size == 1 and world1.rank == 0
    assert world1.backend == "gloo"
    assert mesh_mod.make_data_mesh(_cfg_dp(0)) is None  # 0 -> 1 rank
    with pytest.raises(RuntimeError, match="does not match"):
        mesh_mod.make_data_mesh(_cfg_dp(2))


def test_initialize_distributed(monkeypatch, tmp_path):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert mesh_mod.initialize_distributed() is False
    assert not dist.is_initialized()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "not-a-port")
    with pytest.raises(ValueError):
        mesh_mod.initialize_distributed()
    assert not dist.is_initialized()
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert mesh_mod.initialize_distributed() is True
        assert dist.get_backend() == "gloo"
        assert mesh_mod.initialize_distributed() is False  # already up
    finally:
        dist.destroy_process_group()


def test_shard_range_takes_contiguous_blocks():
    for n, size in ((8, 2), (20, 4), (6, 3), (5, 1)):
        blocks = [mesh_mod.shard_range(n, mesh_mod.DataMesh(
            group=None, size=size, rank=r, backend="gloo"))
            for r in range(size)]
        assert blocks == [(r * n // size, (r + 1) * n // size)
                          for r in range(size)]
    with pytest.raises(ValueError, match="do not split"):
        mesh_mod.shard_range(3, mesh_mod.DataMesh(None, 2, 1, "gloo"))


# -- one rank: bit for bit the single-device step ---------------------------

def test_world1_mesh_is_bit_equal_to_no_mesh(world1):
    from test_torch_train_step import _batch, _cfg

    from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg

    states = []
    for mesh in (None, world1):
        c = _cfg(port_base_cfg, "Adam")
        models = port_trainer.build_models(c, device="cpu", seed=4)
        state = port_trainer.create_train_state(c, models)
        step = port_trainer.make_train_step(c, models, with_pl=True,
                                            mesh=mesh)
        metrics = []
        for i in range(2):
            state, m = step(state, _batch(1 + i, False), _batch(2 + i, True))
            metrics.append({k: v.numpy() for k, v in m.items()})
        states.append((_state_arrays(state), metrics))
    _assert_states_equal(states[1][0], states[0][0], "state")
    for a, b in zip(states[1][1], states[0][1]):
        _assert_states_equal(a, b, "metrics")
    assert world1.collectives == 2 * 6


# -- two ranks against JAX's two-device shard_map -----------------------------

@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    """A pre-EMA and an EMA step (from the same state) of JAX's 2-device
    sharded step and of the port in 2 gloo processes."""
    import flax.linen
    import jax
    import jax.numpy as jnp

    from mopa_tpu.config.xmuda import cfg as jax_base_cfg
    from mopa_tpu.models.torch_compat import flatten_pytree
    from mopa_tpu.train import trainer as jax_trainer
    from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
    from test_torch_ema_step import _ema_batch, _ema_cfg
    from test_torch_train_step import (_batch, _identity_dropout, _jax_batch,
                                       _lift_bn_biases, _np_tree)

    jcfg, pcfg = _ema_cfg(jax_base_cfg, 1.0), _ema_cfg(port_base_cfg, 1.0)
    mp = pytest.MonkeyPatch()
    mp.setattr(flax.linen, "Dropout", _identity_dropout)
    try:
        jmodels, _ = jax_trainer.build_models(jcfg)
        jstate = jax.jit(lambda b: jax_trainer.create_train_state(
            jcfg, jmodels, b, seed=3))(_jax_batch(_batch(0, False)))
        jstate = jstate._replace(
            params_2d=_lift_bn_biases(jstate.params_2d),
            params_3d=_lift_bn_biases(jstate.params_3d))
        jstate = jstate._replace(
            ema_params_2d=jax.tree_util.tree_map(jnp.copy, jstate.params_2d),
            ema_params_3d=jax.tree_util.tree_map(jnp.copy, jstate.params_3d))
        flax_vars = tuple(flatten_pytree(t) for t in (
            jstate.params_2d, jstate.batch_stats_2d, jstate.params_3d,
            jstate.batch_stats_3d))
        mesh = jax.make_mesh((WORLD,), ("data",),
                             devices=jax.devices()[:WORLD])
        pre = jax_trainer.make_train_step(jcfg, jmodels, with_pl=True,
                                          with_ema=False, mesh=mesh)
        ema = jax_trainer.make_train_step(jcfg, jmodels, with_pl=True,
                                          with_ema=True, mesh=mesh,
                                          reuse_step=pre)
        # the pre-EMA pseudo labels in the teacher's int16, so that both
        # steps run one compiled student program
        trg = _batch(2, True)
        for k in ("pseudo_label_2d", "pseudo_label_3d"):
            trg[k] = trg[k].astype(np.int16)
        steps = [("pre", _batch(1, False), trg),
                 ("ema", _batch(3, False), _ema_batch(4))]
        before = {"params_2d": _np_tree(jstate.params_2d),
                  "params_3d": _np_tree(jstate.params_3d)}
        jax_out = []
        for (mode, src, trg), fn in zip(steps, (pre, ema)):
            st = jax.tree_util.tree_map(jnp.copy, jstate)
            new, metrics = fn(st, _jax_batch(src), _jax_batch(trg))
            jax_out.append({
                "metrics": {k: np.asarray(v) for k, v in metrics.items()},
                "params_2d": _np_tree(new.params_2d),
                "params_3d": _np_tree(new.params_3d),
                "stats_2d": _np_tree(new.batch_stats_2d),
                "stats_3d": _np_tree(new.batch_stats_3d)})
    finally:
        mp.undo()
    port = run_workers(tmp_path_factory.mktemp("dp_step"), {
        "kind": "step", "cfg": _plain(pcfg), "flax": flax_vars,
        "steps": steps})
    return dict(before=before, jax=jax_out, port=port)


@pytest.mark.parametrize("i", [0, 1], ids=["pre_ema", "ema"])
def test_two_ranks_match_jax_shard_map(sharded_steps, i):
    jx = sharded_steps["jax"][i]
    ranks = [r[i] for r in sharded_steps["port"]]
    _assert_states_equal(ranks[1]["state"], ranks[0]["state"], "replicas")
    assert ranks[0]["collectives"] == 6 * (i + 1)  # one mesh, 2 steps
    pm = ranks[0]["metrics"]
    assert set(pm) == set(jx["metrics"])
    for k, want in jx["metrics"].items():
        np.testing.assert_array_equal(ranks[1]["metrics"][k], pm[k], k)
        if k.startswith("cm_"):
            np.testing.assert_array_equal(pm[k], want, err_msg=k)
            assert want.sum() > 0
        else:
            np.testing.assert_allclose(pm[k], want, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    got = ranks[0]["flax"]
    for tag in ("stats_2d", "stats_3d"):
        assert set(got[tag]) == set(jx[tag])
        for k, want in jx[tag].items():
            np.testing.assert_allclose(got[tag][k], want, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    for net in ("params_2d", "params_3d"):
        before, want = sharded_steps["before"][net], jx[net]
        top = max(float(np.abs(want[k] - before[k]).max()) for k in want)
        moved = 0
        for k in want:
            d_want = want[k] - before[k]
            d_got = got[net][k] - before[k]
            scale = float(np.abs(d_want).max())
            if k.endswith((".conv.bias", ".tconv.bias")):  # feeds a BN
                assert max(scale, float(np.abs(d_got).max())) <= 1e-4 * top
                continue
            # the new values are float32 numbers near ``before``: a change
            # is known to one spacing of the parameter's magnitude
            ulp = float(np.spacing(np.abs(before[k]).max().astype(
                np.float32)))
            np.testing.assert_allclose(d_got, d_want, rtol=0,
                                       atol=1e-4 * scale + ulp, err_msg=k)
            moved += scale > 0
        assert moved > len(want) // 2


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
