"""The ImageNet ResNet34 encoder load (``train.trainer.create_train_state``
with ``MODEL_2D.UNetResNet34.pretrained``) against ``mopa_tpu``'s.

A random state dict in torchvision's ``resnet34`` layout (``fc`` and
``num_batches_tracked`` included) is saved as a ``.pth`` and, through the
JAX package's ``tools/convert_resnet34.py``, as an ``.npz``. Both packages
load it, named by ``TPU.RESNET34_WEIGHTS`` or by ``$MOPA_RESNET34_WEIGHTS``;
the port starts from JAX's seeded variables (``flax_variables``), so its
whole 2D state must then equal JAX's ``create_train_state`` exactly: the
encoder from the file, the decoder and heads as seeded. The 2D eval forward
of the loaded nets agrees to 1e-5 of the largest logit (the random encoder
drives the logits to ~70). Without a file the port logs JAX's warning and
keeps its weights.
"""

import logging
import os
import sys

import jax
import numpy as np
import pytest
import torch

from mopa_tpu.config.xmuda import cfg as jax_base_cfg
from mopa_tpu.models.torch_compat import flatten_pytree
from mopa_tpu.train import trainer as jax_trainer
from mopa_tpu_torch.config.xmuda import cfg as port_base_cfg
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.train import trainer as port_trainer
from test_torch_train_step import _batch, _cfg, _np_tree

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import convert_resnet34  # noqa: E402

torch.set_num_threads(1)


def _torchvision_resnet34(seed: int) -> dict:
    """Random tensors under torchvision's resnet34 names and shapes."""
    rng = np.random.default_rng(seed)
    net = port_trainer.build_models(_cfg(port_base_cfg), device="cpu"
                                    ).model_2d.state_dict()
    sd = {}

    def conv(src, dst):
        shape = net[dst + ".weight"].shape
        sd[src + ".weight"] = torch.from_numpy(
            rng.normal(0, 0.05, shape).astype(np.float32))

    def bn(src, dst):
        c = net[dst + ".scale"].shape[0]
        sd[src + ".weight"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, c).astype(np.float32))
        sd[src + ".bias"] = torch.from_numpy(
            rng.normal(0, 0.1, c).astype(np.float32))
        sd[src + ".running_mean"] = torch.from_numpy(
            rng.normal(0, 0.1, c).astype(np.float32))
        sd[src + ".running_var"] = torch.from_numpy(
            rng.uniform(0.5, 2.0, c).astype(np.float32))
        sd[src + ".num_batches_tracked"] = torch.tensor(7)

    conv("conv1", "net_2d.conv1")
    bn("bn1", "net_2d.bn1")
    for layer, n_blocks in weights.RESNET34_BLOCKS.items():
        for b in range(n_blocks):
            src, dst = "{}.{}".format(layer, b), \
                "net_2d.{}.block{}".format(layer, b)
            conv(src + ".conv1", dst + ".conv1")
            bn(src + ".bn1", dst + ".bn1")
            conv(src + ".conv2", dst + ".conv2")
            bn(src + ".bn2", dst + ".bn2")
            if dst + ".downsample_conv.weight" in net:
                conv(src + ".downsample.0", dst + ".downsample_conv")
                bn(src + ".downsample.1", dst + ".downsample_bn")
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def _jax_batch(batch):
    return {k: jax.numpy.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("resnet34")
    sd = _torchvision_resnet34(0)
    pth = str(d / "resnet34.pth")
    torch.save(sd, pth)
    npz = str(d / "resnet34.npz")
    convert_resnet34.convert(pth, npz)
    return {"pth": pth, "npz": npz, "sd": sd}


def _cfgs(path):
    out = []
    for base in (jax_base_cfg, port_base_cfg):
        c = _cfg(base)
        c.MODEL_2D.UNetResNet34.pretrained = True
        c.TPU.RESNET34_WEIGHTS = path
        out.append(c)
    return out


@pytest.fixture(scope="module")
def jax_init():
    """JAX's seeded variables (no pretrained load), flattened."""
    jcfg = _cfg(jax_base_cfg)
    models, _ = jax_trainer.build_models(jcfg)
    state = jax.jit(lambda b: jax_trainer.create_train_state(
        jcfg, models, b, seed=3))(_jax_batch(_batch(0, False)))
    return tuple(flatten_pytree(t) for t in (
        state.params_2d, state.batch_stats_2d, state.params_3d,
        state.batch_stats_3d))


@pytest.fixture(scope="module")
def loaded(files, jax_init):
    """Per file kind: (JAX's state, its models, the port's models and
    state) after the pretrained load."""
    out = {}
    for kind in ("pth", "npz"):
        jcfg, pcfg = _cfgs(files[kind])
        jmodels, _ = jax_trainer.build_models(jcfg)
        jstate = jax.jit(lambda b: jax_trainer.create_train_state(
            jcfg, jmodels, b, seed=3))(_jax_batch(_batch(0, False)))
        pmodels = port_trainer.build_models(pcfg, device="cpu")
        pstate = port_trainer.create_train_state(pcfg, pmodels,
                                                 flax_variables=jax_init)
        out[kind] = (jstate, jmodels, pmodels, pstate)
    return out


@pytest.mark.parametrize("kind", ["pth", "npz"])
def test_loaded_2d_weights_equal_jax(loaded, jax_init, files, kind):
    jstate, _, pmodels, pstate = loaded[kind]
    want = {**_np_tree(jstate.params_2d), **_np_tree(jstate.batch_stats_2d)}
    got = weights.to_flax(pmodels.model_2d, {**pstate.params_2d,
                                             **pstate.batch_stats_2d})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the encoder came from the file, the decoder kept its seeded weights
    init = {**jax_init[0], **jax_init[1]}
    enc = "net_2d.layer3.block2.conv1.kernel"
    np.testing.assert_array_equal(
        got[enc], np.transpose(files["sd"]["layer3.2.conv1.weight"].numpy(),
                               (2, 3, 1, 0)))
    np.testing.assert_array_equal(got["net_2d.bn1.var"],
                                  files["sd"]["bn1.running_var"].numpy())
    dec = "net_2d.dec_conv_stage2.conv.kernel"
    np.testing.assert_array_equal(got[dec], init[dec])
    # the EMA teacher starts from the loaded weights
    ema = weights.to_flax(pmodels.model_2d, pstate.ema_params_2d)
    np.testing.assert_array_equal(ema[enc], got[enc])


@pytest.mark.parametrize("kind", ["pth", "npz"])
def test_loaded_2d_forward_agrees(loaded, kind):
    jstate, jmodels, pmodels, _ = loaded[kind]
    batch = _batch(5, False)
    img = batch["img"].astype(np.float32) / 255.0
    idx = batch["img_indices"].astype(np.int32)
    valid = (np.arange(idx.shape[1])[None]
             < batch["num_points"][:, None])
    want = jmodels.model_2d.apply(
        {"params": jstate.params_2d, "batch_stats": jstate.batch_stats_2d},
        jax.numpy.asarray(img), jax.numpy.asarray(idx),
        jax.numpy.asarray(valid), train=False)
    net = pmodels.model_2d.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(img), torch.from_numpy(idx).long(),
                  torch.from_numpy(valid))
    for k in ("seg_logit", "seg_logit2"):
        ref = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)


def test_environment_variable_names_the_file(files, jax_init, monkeypatch):
    _, pcfg = _cfgs("")
    monkeypatch.setenv("MOPA_RESNET34_WEIGHTS", files["npz"])
    assert port_trainer.resolve_resnet34_weights(pcfg) == files["npz"]
    models = port_trainer.build_models(pcfg, device="cpu")
    port_trainer.create_train_state(pcfg, models, flax_variables=jax_init)
    np.testing.assert_array_equal(
        models.model_2d.state_dict()["net_2d.conv1.weight"].numpy(),
        files["sd"]["conv1.weight"].numpy())


def test_warning_without_a_weights_file(jax_init, monkeypatch, caplog):
    monkeypatch.delenv("MOPA_RESNET34_WEIGHTS", raising=False)
    # setup_logger (the CLIs, common.get_logger) stops the package logger's
    # propagation for the rest of the process; caplog listens on the root
    monkeypatch.setattr(logging.getLogger("mopa_tpu_torch"), "propagate", True)
    _, pcfg = _cfgs("/nonexistent/resnet34.pth")
    assert port_trainer.resolve_resnet34_weights(pcfg) == ""
    models = port_trainer.build_models(pcfg, device="cpu")
    with caplog.at_level(logging.WARNING, logger="mopa_tpu_torch"):
        port_trainer.create_train_state(pcfg, models,
                                        flax_variables=jax_init)
    assert any("no resnet34 weights file found" in r.getMessage()
               for r in caplog.records)
    np.testing.assert_array_equal(
        weights.to_flax(models.model_2d, dict(
            models.model_2d.named_parameters()))["net_2d.conv1.kernel"],
        jax_init[0]["net_2d.conv1.kernel"])
    caplog.clear()
    pcfg.MODEL_2D.UNetResNet34.pretrained = False
    with caplog.at_level(logging.WARNING, logger="mopa_tpu_torch"):
        port_trainer.create_train_state(pcfg, models)
    assert not caplog.records


def test_encoder_map_reads_prefixed_names_and_rejects_missing(files):
    sd = {"module.net_2d." + k: v for k, v in files["sd"].items()}
    plain = weights.load_resnet34_encoder(files["sd"])
    prefixed = weights.load_resnet34_encoder(sd)
    assert plain.keys() == prefixed.keys()
    assert len(plain) == 1 + 4 + sum(
        2 * 5 for n in weights.RESNET34_BLOCKS.values() for _ in range(n)) \
        + 3 * 5
    broken = dict(files["sd"])
    del broken["layer2.0.downsample.1.running_var"]
    with pytest.raises(KeyError):
        weights.load_resnet34_encoder(broken)
