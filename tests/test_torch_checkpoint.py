"""The port's checkpoints against ``mopa_tpu``'s: the ``.pth`` streams of
``common.checkpoint`` and ``train.trainer.CheckpointAdapter``.

* The checkpointer: pointer file, ``max_to_keep`` ring and resume, as
  ``tests/test_common.py::test_checkpointer_ring_and_resume`` holds the JAX
  package's.
* The port's own round trip after two real steps (Adam and SGD, with and
  without weight decay): every parameter, batch-norm buffer, EMA tensor,
  optimizer moment and step, the update count, the next learning rate and
  ``state.step`` come back bit for bit.
* Across the packages, on the small nets of ``test_torch_train_step.py``
  with every leaf of a JAX train state seeded at random: JAX's ``.pth``
  loaded by the port and saved again gives JAX's file back bit for bit,
  name by name (params, batch stats, EMA, optax's ``mu``/``nu``/``count``
  or ``trace``, the schedule's count, the step); the port's ``.pth``
  loaded by JAX's adapter gives JAX's state back bit for bit; both files
  hold the same keys. With JAX's moments set to the parameters (x1, x2,
  x3) the port's ``exp_avg`` / ``exp_avg_sq`` / ``momentum_buffer`` equal
  its loaded parameters (x1, x2, x3): the optax names and the kernel
  layouts are read right, independently of the port's own writer.
* A missing, extra or misshapen name raises; ``resume_states=False`` loads
  the weights and the step only.

JAX's own adapter writes optax's state by index (``flatten_pytree`` walks a
NamedTuple as a tuple) but reads it back by field name
(``torch_compat.unflatten_into`` walks a NamedTuple by ``_fields``), so no
name matches and its resume keeps a fresh optimizer state, silently
(``test_jax_adapter_drops_its_own_optimizer_state``; ROADMAP Queue 3). Where
JAX loads a file here, its ``unflatten_into`` is patched to read by index
(:func:`unflatten_by_index`), as its writer wrote.
"""

import os
import pathlib
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.common import checkpoint as jax_ckpt
from mopa_tpu.common.solver import build_optimizer as jax_build_optimizer
from mopa_tpu.config.xmuda import cfg as jax_base_cfg
from mopa_tpu.models.torch_compat import flatten_pytree
from mopa_tpu.train import trainer as jax_trainer
from mopa_tpu_torch.common.checkpoint import CheckpointerV2
from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.train import trainer as port_trainer
from test_torch_train_step import _batch, _cfg, _jax_batch

torch.set_num_threads(1)

# (optimizer, weight decay) and the JAX package's names of its moments
VARIANTS = {("Adam", 0.0): ("0.1", "0.2"), ("Adam", 1e-4): ("1.0.1", "1.0.2"),
            ("SGD", 0.0): ("0.0",), ("SGD", 1e-4): ("1.0.0",)}
IDS = ["{}-wd{}".format(k, w) for k, w in VARIANTS]
# (variant, net): every optimizer on the small 3D net, the shipped Adam on
# the 2D net too (24M parameters: seconds per stream on the CPU)
CASES = [(v, "3d") for v in VARIANTS] + [(("Adam", 0.0), "2d")]
CASE_IDS = ["{}-wd{}-{}".format(k, w, n) for (k, w), n in CASES]


def unflatten_by_index(template, flat):
    """``torch_compat.unflatten_into`` reading NamedTuples by index, as
    ``flatten_pytree`` writes them (the JAX package reads them by field
    name, so no optax name matches)."""
    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [visit(v, path + (str(i),)) for i, v in enumerate(node)]
            return type(node)(*vals) if hasattr(node, "_fields") \
                else type(node)(vals)
        if node is None:
            return None
        key = ".".join(path)
        if key not in flat:
            return node
        val = np.asarray(flat[key])
        if tuple(val.shape) != tuple(node.shape):
            raise ValueError("shape mismatch for {}".format(key))
        return jnp.asarray(val, dtype=node.dtype)

    return visit(template, ())


@pytest.fixture
def tmp_path():
    """A directory removed after the test: a 2D stream is ~0.4 GB, which
    pytest's kept temporary directories would pile up."""
    path = tempfile.mkdtemp(prefix="mopa-ckpt-test-")
    yield pathlib.Path(path)
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def jax_reads_by_index(monkeypatch):
    from mopa_tpu.models import torch_compat

    monkeypatch.setattr(torch_compat, "unflatten_into", unflatten_by_index)


def _cfgs(kind, wd):
    kw = {"OPTIMIZER.MODEL_2D.WEIGHT_DECAY": wd,
          "OPTIMIZER.MODEL_3D.WEIGHT_DECAY": wd,
          "OPTIMIZER.MODEL_2D.BASE_LR": 0.01,
          "OPTIMIZER.MODEL_3D.BASE_LR": 0.01}
    return _cfg(jax_base_cfg, kind, **kw), _cfg(port_base_cfg, kind, **kw)


class _DictState:
    def __init__(self):
        self.d = {"model": {"w": np.arange(4, dtype=np.float32)}}

    def state_dict(self):
        return self.d

    def load_state_dict(self, ckpt, resume_states=True):
        self.d["model"] = ckpt["model"]
        return {k: v for k, v in ckpt.items() if k != "model"}


def test_checkpointer_ring_and_resume(tmp_path):
    sp = _DictState()
    ck = CheckpointerV2(sp, save_dir=str(tmp_path), postfix="_2d",
                        max_to_keep=2)
    for i in (1, 2, 3):
        ck.save("model_{:06d}".format(i), iteration=i)
    files = sorted(os.listdir(tmp_path))
    assert "model_000001.pth" not in files  # evicted by the ring
    assert {"model_000002.pth", "model_000003.pth", "last_checkpoint_2d",
            "checkpoint_ring_2d"} <= set(files)
    assert (tmp_path / "last_checkpoint_2d").read_text() == "model_000003.pth"

    sp2 = _DictState()
    sp2.d["model"]["w"] = np.zeros(4, dtype=np.float32)
    ck2 = CheckpointerV2(sp2, save_dir=str(tmp_path), postfix="_2d",
                         max_to_keep=2)
    extra = ck2.load(resume=True)
    assert extra.get("iteration") == 3
    np.testing.assert_array_equal(sp2.d["model"]["w"],
                                  np.arange(4, dtype=np.float32))
    # the ring survives the new instance: the next save evicts the oldest
    ck2.save("model_000004", iteration=4)
    ck2.save("best", tag=False)  # untagged: outside the ring and pointer
    files = set(os.listdir(tmp_path))
    assert "model_000002.pth" not in files and "best.pth" in files
    assert (tmp_path / "last_checkpoint_2d").read_text() == "model_000004.pth"
    # the JAX package's checkpointer reads the port's pointer and file
    jx = jax_ckpt.CheckpointerV2(_DictState(), save_dir=str(tmp_path),
                                 postfix="_2d")
    assert jx.load(resume=True)["iteration"] == 4


def test_checkpointer_without_dir_or_pointer(tmp_path):
    assert CheckpointerV2(_DictState()).save("x") is None
    ck = CheckpointerV2(_DictState(), save_dir=str(tmp_path))
    assert ck.load(resume=True) == {}
    (tmp_path / "last_checkpoint").write_text("")
    assert ck.load(resume=True) == {}


# ----- the port's own round trip -------------------------------------------

def _port_setup(pcfg, seed=4):
    models = port_trainer.build_models(pcfg, device="cpu", seed=seed)
    models.model_2d.net_2d.dropout_rate = 0.0
    return models, port_trainer.create_train_state(pcfg, models)


def _assert_states_equal(a, b, nets):
    assert a.step == b.step
    for net in nets:
        for kind in ("params_", "batch_stats_", "ema_params_"):
            ta, tb = getattr(a, kind + net), getattr(b, kind + net)
            assert set(ta) == set(tb)
            for k in ta:
                assert torch.equal(ta[k], tb[k]), kind + net + k
        oa, ob = getattr(a, "opt_" + net), getattr(b, "opt_" + net)
        assert oa.count == ob.count
        assert oa.lr_schedule(oa.count) == ob.lr_schedule(ob.count)
        assert [g["lr"] for g in ob.optimizer.param_groups] == \
            [ob.lr_schedule(ob.count)] * len(ob.optimizer.param_groups)
        pa, pb = getattr(a, "params_" + net), getattr(b, "params_" + net)
        for k in pa:
            sa = oa.optimizer.state.get(pa[k], {})
            sb = ob.optimizer.state[pb[k]]
            for key, v in sa.items():
                assert torch.equal(sb[key], v), (net, k, key)
                assert sb[key].dtype == v.dtype


@pytest.mark.parametrize("variant", list(VARIANTS), ids=IDS)
def test_port_round_trip_is_bit_exact(tmp_path, variant):
    _, pcfg = _cfgs(*variant)
    models, state = _port_setup(pcfg)
    step = port_trainer.make_train_step(pcfg, models, with_pl=True)
    for i in range(2):
        state, _ = step(state, _batch(1 + 2 * i, False), _batch(2 + 2 * i,
                                                               True))
    nets = ("2d", "3d") if variant == ("Adam", 0.0) else ("3d",)
    for which in nets:
        ck = CheckpointerV2(port_trainer.CheckpointAdapter(which, models,
                                                           state),
                            save_dir=str(tmp_path), postfix="_" + which)
        ck.save("model_{}_000002".format(which), iteration=state.step)
    models2, state2 = _port_setup(pcfg, seed=9)
    for which in nets:
        ck = CheckpointerV2(port_trainer.CheckpointAdapter(which, models2,
                                                           state2),
                            save_dir=str(tmp_path), postfix="_" + which)
        assert ck.load(resume=True)["iteration"] == 2
    assert state.step == 2 and state.opt_3d.count == 2
    _assert_states_equal(state, state2, nets)


# ----- across the packages --------------------------------------------------

@pytest.fixture(scope="module")
def jax_variables():
    """Params and batch stats of JAX's small nets (the flax init)."""
    jcfg, _ = _cfgs("Adam", 0.0)
    jmodels, _ = jax_trainer.build_models(jcfg)
    state = jax.jit(lambda b: jax_trainer.create_train_state(
        jcfg, jmodels, b, seed=3))(_jax_batch(_batch(0, False)))
    return state


def _randomized(tree, rng, count):
    def leaf(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return jnp.asarray(np.full(x.shape, count, x.dtype))
        return jnp.asarray(rng.standard_normal(x.shape, np.float32))
    return jax.tree_util.tree_map(leaf, tree)


def _with_moments_from(opt, params, prefixes):
    """The optax state ``opt`` with each moment set to the params times
    1, 2, 3 (in the order of ``prefixes``), by the JAX package's names."""
    flat = flatten_pytree(params)
    over = {}
    for factor, prefix in enumerate(prefixes, start=1):
        for name, value in flat.items():
            over[prefix + "." + name] = value * factor
    return unflatten_by_index(opt, over)


def _jax_state(base, variant, seed, net, moments_from_params=False):
    """JAX's train state with ``net``'s params, batch stats, EMA and
    optimizer state (``variant``) seeded at random, the step 7."""
    jcfg, _ = _cfgs(*variant)
    rng = np.random.default_rng(seed)
    tx = jax_build_optimizer(jcfg.OPTIMIZER["MODEL_" + net.upper()], jcfg)
    params = _randomized(getattr(base, "params_" + net), rng, 0)
    opt = _randomized(tx.init(params), rng, 7)
    ema = _randomized(params, rng, 0)
    if moments_from_params:
        opt = _with_moments_from(opt, params, VARIANTS[variant])
        ema = jax.tree_util.tree_map(lambda x: x * 3.0, params)
    return base._replace(step=jnp.asarray(7, jnp.int32), **{
        "params_" + net: params, "opt_" + net: opt,
        "ema_params_" + net: ema, "batch_stats_" + net: _randomized(
            getattr(base, "batch_stats_" + net), rng, 0)})


def _jax_adapter(holder, which):
    return jax_trainer.CheckpointAdapter(
        which, lambda: holder["s"], lambda s: holder.__setitem__("s", s))


def _jax_save(state, path, which):
    jax_ckpt.CheckpointerV2(_jax_adapter({"s": state}, which), save_dir=path,
                            postfix="_" + which).save(
        "model_{}_000007".format(which), iteration=7, best_seg_iou=0.25)


def _jax_load(template, path, which):
    holder = {"s": template}
    jax_ckpt.CheckpointerV2(_jax_adapter(holder, which), save_dir=path,
                            postfix="_" + which).load(resume=True)
    return holder["s"]


def _port_adapter(models, state, which, path):
    return CheckpointerV2(port_trainer.CheckpointAdapter(which, models,
                                                         state),
                          save_dir=path, postfix="_" + which)


def _port_load(pcfg, path, which, resume_states=True):
    models, state = _port_setup(pcfg, seed=11)
    extra = _port_adapter(models, state, which, path).load(
        resume=True, resume_states=resume_states)
    assert extra == {"iteration": 7, "best_seg_iou": 0.25}
    return models, state


def _assert_same_file(a, b):
    """Two ``.pth`` files hold the same keys and, name by name, the same
    dtypes, shapes and bits."""
    da = torch.load(a, map_location="cpu", weights_only=False)
    db = torch.load(b, map_location="cpu", weights_only=False)
    assert set(da) == set(db)
    for key in da:
        if not isinstance(da[key], dict):
            assert da[key] == db[key], key
            continue
        assert set(da[key]) == set(db[key]), key
        for name, va in da[key].items():
            vb = db[key][name]
            if not isinstance(va, np.ndarray):
                assert va == vb, (key, name)
                continue
            assert va.dtype == vb.dtype and va.shape == vb.shape, (key, name)
            assert va.tobytes() == vb.tobytes(), (key, name)


@pytest.mark.parametrize("variant,which", CASES, ids=CASE_IDS)
def test_jax_checkpoint_resumes_in_port_bit_exact(tmp_path, jax_variables,
                                                  variant, which,
                                                  jax_reads_by_index):
    _, pcfg = _cfgs(*variant)
    jstate = _jax_state(jax_variables, variant, 1, which)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jdir)
    os.makedirs(pdir)
    _jax_save(jstate, jdir, which)
    models, state = _port_load(pcfg, jdir, which)
    assert state.step == 7 and getattr(state, "opt_" + which).count == 7
    _port_adapter(models, state, which, pdir).save(
        "model_{}_000007".format(which), iteration=7, best_seg_iou=0.25)
    name = "model_{}_000007.pth".format(which)
    _assert_same_file(os.path.join(jdir, name), os.path.join(pdir, name))
    # the port's file, loaded by JAX's adapter, gives JAX's state back
    jcfg, _ = _cfgs(*variant)
    tx = jax_build_optimizer(jcfg.OPTIMIZER["MODEL_" + which.upper()], jcfg)
    base = getattr(jax_variables, "params_" + which)
    template = jax_variables._replace(step=jnp.asarray(0, jnp.int32), **{
        "opt_" + which: tx.init(base)})
    back = _jax_load(template, pdir, which)
    assert int(back.step) == 7
    for part in ("params_", "batch_stats_", "opt_", "ema_params_"):
        want = flatten_pytree(getattr(jstate, part + which))
        got = flatten_pytree(getattr(back, part + which))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), part + k


@pytest.mark.parametrize("variant,which", CASES, ids=CASE_IDS)
def test_jax_moments_land_in_the_parameters_layout(tmp_path, jax_variables,
                                                   variant, which):
    _, pcfg = _cfgs(*variant)
    _jax_save(_jax_state(jax_variables, variant, 3, which,
                         moments_from_params=True), str(tmp_path), which)
    _, state = _port_load(pcfg, str(tmp_path), which)
    keys = ({"Adam": ("exp_avg", "exp_avg_sq"), "SGD": ("momentum_buffer",)}
            [variant[0]])
    params = getattr(state, "params_" + which)
    opt = getattr(state, "opt_" + which)
    ema = getattr(state, "ema_params_" + which)
    for k, p in params.items():
        assert torch.equal(ema[k], p.detach() * 3.0), k
        st = opt.optimizer.state[p]
        if variant[0] == "Adam":
            assert st["step"].item() == 7.0
        for factor, key in enumerate(keys, start=1):
            assert torch.equal(st[key], p.detach() * factor), (k, key)
    assert opt.count == 7
    assert opt.optimizer.param_groups[0]["lr"] == opt.lr_schedule(7)


def test_resume_states_false_loads_weights_only(tmp_path, jax_variables):
    variant = ("Adam", 0.0)
    _, pcfg = _cfgs(*variant)
    _jax_save(_jax_state(jax_variables, variant, 4, "3d"), str(tmp_path),
              "3d")
    models, state = _port_load(pcfg, str(tmp_path), "3d", resume_states=False)
    _, fresh = _port_setup(pcfg, seed=11)
    assert state.step == 7 and state.opt_3d.count == 0
    assert not state.opt_3d.optimizer.state
    want = {k[len("params."):]: v for k, v in torch.load(
        str(tmp_path / "model_3d_000007.pth"), weights_only=False)[
        "model"].items() if k.startswith("params.")}
    got = weights.to_flax(models.model_3d, state.params_3d)
    assert set(got) == set(want)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    for k, v in state.ema_params_3d.items():
        assert torch.equal(v, fresh.ema_params_3d[k]), k


@pytest.mark.parametrize("edit,error", [
    ("drop_param", KeyError), ("extra_param", KeyError),
    ("bad_shape", ValueError), ("bad_group", KeyError),
    ("extra_slot", KeyError), ("drop_count", KeyError),
    ("drop_moment", KeyError), ("bad_ema", KeyError)])
def test_adapter_rejects_a_bad_name(tmp_path, jax_variables, edit, error):
    variant = ("Adam", 0.0)
    _, pcfg = _cfgs(*variant)
    _jax_save(_jax_state(jax_variables, variant, 5, "3d"), str(tmp_path),
              "3d")
    ckpt = torch.load(str(tmp_path / "model_3d_000007.pth"),
                      weights_only=False)
    model, opt = ckpt["model"], ckpt["optimizer"]
    name = next(k for k in model if k.startswith("params."))
    if edit == "drop_param":
        del model[name]
    elif edit == "extra_param":
        model["params.nowhere.kernel"] = model[name]
    elif edit == "bad_shape":
        model[name] = np.zeros(model[name].shape + (2,), np.float32)
    elif edit == "bad_group":
        model["other." + name] = model.pop(name)
    elif edit == "extra_slot":
        opt["3.0"] = np.zeros((), np.int32)
    elif edit == "drop_count":
        del opt["1.0"]
    elif edit == "drop_moment":
        del opt[next(k for k in opt if k.startswith("0.2."))]
    else:
        ckpt["ema"]["nowhere.bias"] = np.zeros(1, np.float32)
    models, state = _port_setup(pcfg)
    adapter = port_trainer.CheckpointAdapter("3d", models, state)
    with pytest.raises(error):
        adapter.load_state_dict(ckpt)


def test_jax_adapter_drops_its_own_optimizer_state(tmp_path, jax_variables):
    """JAX resuming from its own file gets its params back but keeps the
    template's optimizer state (a fresh Adam: count 0, zero moments); the
    port, loading the same file, gets the saved moments and count."""
    variant = ("Adam", 0.0)
    jcfg, pcfg = _cfgs(*variant)
    saved = _jax_state(jax_variables, variant, 6, "3d")
    _jax_save(saved, str(tmp_path), "3d")
    tx = jax_build_optimizer(jcfg.OPTIMIZER.MODEL_3D, jcfg)
    fresh_opt = tx.init(saved.params_3d)
    back = _jax_load(saved._replace(opt_3d=fresh_opt), str(tmp_path), "3d")
    got, fresh = flatten_pytree(back.opt_3d), flatten_pytree(fresh_opt)
    assert all(np.array_equal(got[k], fresh[k]) for k in fresh)
    assert int(got["0.0"]) == 0
    assert int(flatten_pytree(saved.opt_3d)["0.0"]) == 7
    want = flatten_pytree(saved.params_3d)
    assert all(np.array_equal(v, want[k])
               for k, v in flatten_pytree(back.params_3d).items())
    _, state = _port_load(pcfg, str(tmp_path), "3d")
    assert state.opt_3d.count == 7
