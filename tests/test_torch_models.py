"""The port's networks against the JAX reference, in float32 eval mode.

Weights come from the reference's flax ``init`` and cross through the port's
weight bridge (``mopa_tpu_torch.models.weights``); batch statistics are
perturbed away from (0, 1) so the eval batch norms are exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopa_tpu.models import resnet34_unet as jax_r34
from mopa_tpu.models import scn_unet as jax_unet
from mopa_tpu.models import xmuda_arch as jax_arch
from mopa_tpu.models.torch_compat import flatten_pytree
from mopa_tpu_torch.models import resnet34_unet as port_r34
from mopa_tpu_torch.models import scn_unet as port_unet
from mopa_tpu_torch.models import weights
from mopa_tpu_torch.models import xmuda_arch as port_arch

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
NCLS = 10


def perturbed_stats(stats, seed):
    """Flattened batch stats with mean ~ N(0, 0.1) and var ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sorted(flatten_pytree(stats).items()):
        out[k] = (rng.normal(0, 0.1, v.shape) if k.endswith(".mean")
                  else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
    return out


def nest(flat):
    """{"a.b": x} -> {"a": {"b": x}} as jnp arrays (flax variable layout)."""
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def image_inputs(rng, b, h, w, p):
    img = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    idx = np.stack([rng.integers(0, h, (b, p)), rng.integers(0, w, (b, p))],
                   -1).astype(np.int32)
    valid = np.ones((b, p), bool)
    valid[-1, p // 2:] = False
    return img, idx, valid


def scan_inputs(rng, s, p):
    coords = rng.integers(0, 20, size=(s, p, 3)).astype(np.int32)
    valid = np.ones((s, p), bool)
    valid[-1, int(p * 0.7):] = False
    feats = rng.normal(size=(s * p, 1)).astype(np.float32)
    return coords, valid, feats


def both_plans(coords, valid, levels):
    caps = jax_unet.capacity_schedule(coords.shape[1], levels)
    ref = jax_unet.build_unet_plan_batched(
        jnp.asarray(coords), jnp.asarray(valid), levels, capacities=caps)
    port = port_unet.build_unet_plan_batched(
        torch.from_numpy(coords), torch.from_numpy(valid), levels,
        capacities=caps)
    return ref, port


@pytest.mark.parametrize("h,w", [(32, 48), (30, 44)])
def test_unet_resnet34(h, w):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    model = jax_r34.UNetResNet34(pretrained=False)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(img))
    stats = perturbed_stats(variables["batch_stats"], 1)
    want = model.apply({"params": variables["params"],
                        "batch_stats": nest(stats)}, jnp.asarray(img))
    port = port_r34.UNetResNet34()
    weights.load_flax_state(port, flatten_pytree(variables["params"]), stats)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(img))
    assert got.shape == (2, h, w, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sparse_unet():
    rng = np.random.default_rng(2)
    coords, valid, feats = scan_inputs(rng, 2, 300)
    ref_plan, port_plan = both_plans(coords, valid, 3)
    model = jax_unet.SparseUNet(in_channels=1, m=4, num_planes=3)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(feats),
                           ref_plan)
    stats = perturbed_stats(variables["batch_stats"], 3)
    want = model.apply({"params": variables["params"],
                        "batch_stats": nest(stats)}, jnp.asarray(feats),
                       ref_plan)
    port = port_unet.SparseUNet(in_channels=1, m=4, num_planes=3)
    weights.load_flax_state(port, flatten_pytree(variables["params"]), stats)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(feats), port_plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_net2d_net3d_segmentation_heads():
    rng = np.random.default_rng(4)
    b, h, w, p = 2, 32, 48, 256
    img, idx, pvalid = image_inputs(rng, b, h, w, p)
    coords, valid, feats = scan_inputs(rng, b, p)
    ref_plan, port_plan = both_plans(coords, valid, 3)

    j2d = jax_arch.Net2DSeg(num_classes=NCLS, dual_head=True,
                            pretrained=False)
    j3d = jax_arch.Net3DSeg(num_classes=NCLS, dual_head=True, m=4,
                            num_planes=3)
    v2d = j2d.init(jax.random.PRNGKey(2), jnp.asarray(img), jnp.asarray(idx),
                   jnp.asarray(pvalid))
    v3d = j3d.init(jax.random.PRNGKey(3), jnp.asarray(feats), ref_plan)
    s2d = perturbed_stats(v2d["batch_stats"], 5)
    s3d = perturbed_stats(v3d["batch_stats"], 6)
    want2d = j2d.apply({"params": v2d["params"], "batch_stats": nest(s2d)},
                       jnp.asarray(img), jnp.asarray(idx), jnp.asarray(pvalid))
    want3d = j3d.apply({"params": v3d["params"], "batch_stats": nest(s3d)},
                       jnp.asarray(feats), ref_plan)

    p2d = port_arch.Net2DSeg(NCLS, True)
    p3d = port_arch.Net3DSeg(NCLS, True, m=4, num_planes=3)
    weights.load_flax_params(p2d, p3d, flatten_pytree(v2d["params"]), s2d,
                             flatten_pytree(v3d["params"]), s3d)
    with torch.no_grad():
        got2d = p2d.eval()(torch.from_numpy(img), torch.from_numpy(idx),
                           torch.from_numpy(pvalid))
        got3d = p3d.eval()(torch.from_numpy(feats), port_plan)
    assert set(got2d) == set(want2d) and set(got3d) == set(want3d)
    for got, want in ((got2d, want2d), (got3d, want3d)):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, **TOL)


def test_weight_bridge_fails_loudly():
    p3d = port_arch.Net3DSeg(NCLS, False, m=4, num_planes=2)
    params = {k: v.detach().numpy().copy()
              for k, v in p3d.named_parameters()}
    params["linear.kernel"] = params.pop("linear.weight").T
    stats = {k: v.numpy().copy() for k, v in p3d.named_buffers()}
    weights.load_flax_state(p3d, params, stats)
    with pytest.raises(KeyError, match="no flax variable"):
        weights.load_flax_state(
            p3d, {k: v for k, v in params.items() if k != "net_3d.stem"},
            stats)
    with pytest.raises(KeyError, match="no counterpart"):
        weights.load_flax_state(p3d, dict(params, extra=np.zeros(1)), stats)
    with pytest.raises(ValueError, match="shape mismatch"):
        weights.load_flax_state(
            p3d, dict(params, **{"net_3d.stem": np.zeros((27, 1, 5))}), stats)
