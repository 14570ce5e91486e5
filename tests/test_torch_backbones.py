"""SPVCNN, SalsaNext and the depth head of the port against the JAX package,
module by module, on the CPU in float32.

Weights come from the reference's flax ``init`` (jitted: flax's init
dispatched op by op takes tens of seconds on the CPU) and cross through
``models.weights.load_flax_state``; eval-mode batch statistics are perturbed
away from (0, 1). Dropout is off on both sides (rate 0), since the two
packages draw different random bits.

Tolerances: single ops (pooling, pixel shuffle, the point maps) to 1e-5;
whole nets (SPVCNN at ``cs`` 8-16 over a 5-level plan of two scans,
SalsaNext at base 8 on 16 x 64 and 13 x 50 range images, the depth head)
to 1e-4 of the largest |value| in outputs, running statistics and
gradients (SalsaNext's gradients to 5e-4, see there), which is inside the
whole-net bar of ``tests/test_parity_golden.py:67-71`` (logit delta <
5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from mopa_tpu.data.utils import augmentation_3d as jax_aug
from mopa_tpu.data.utils import depth_label as jax_depth
from mopa_tpu.models import resnet34_unet as jax_r34
from mopa_tpu.models import salsanext as jax_salsa
from mopa_tpu.models import scn_unet as jax_unet
from mopa_tpu.models import spvcnn as jax_spv
from mopa_tpu.models.torch_compat import flatten_pytree
from mopa_tpu_torch.data.utils import augmentation_3d, depth_label
from mopa_tpu_torch.models import resnet34_unet as port_r34
from mopa_tpu_torch.models import salsanext as port_salsa
from mopa_tpu_torch.models import scn_unet as port_unet
from mopa_tpu_torch.models import spvcnn as port_spv
from mopa_tpu_torch.models import weights

from test_torch_models import nest, perturbed_stats
from test_torch_train_step import _identity_dropout

torch.set_num_threads(1)

TINY_CS = (8, 8, 16, 16, 16, 16, 16, 8, 8)


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-30))


def _load(port, variables, stats=None):
    """Load flax ``variables`` (params, and ``stats`` or their own batch
    stats) into ``port``; check the bridge's way back gives the same names
    and arrays."""
    params = flatten_pytree(variables["params"])
    if stats is None:
        stats = flatten_pytree(variables.get("batch_stats", {}))
    weights.load_flax_state(port, params, stats)
    back = weights.to_flax(port, dict(port.state_dict()))
    assert set(back) == set(params) | set(stats)
    for k, v in {**params, **stats}.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def _grads_close(port, jax_grads, rel=1e-4, zero=()):
    """Every gradient to ``rel`` of its largest |value|; those of the names
    ending in ``zero`` (a bias that feeds a batch norm: its exact gradient
    is 0) to ``rel`` of the largest gradient of the net."""
    got = weights.to_flax(port, {k: p.grad for k, p in
                                 port.named_parameters()})
    want = flatten_pytree(jax_grads)
    assert set(got) == set(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    moved = 0
    for k in want:
        if k.endswith(zero) and zero:
            assert max(float(np.abs(got[k]).max()),
                       float(np.abs(want[k]).max())) <= rel * top, k
            continue
        _close(got[k], want[k], rel)
        moved += float(np.abs(want[k]).max()) > 0
    assert moved > len(want) // 2


def _plans(coords, valid, doms=None):
    """The JAX package's (jitted) and the port's 5-level plans of the same
    scans, in BN domains ``doms``."""
    caps = jax_unet.capacity_schedule(coords.shape[1], jax_spv.NUM_LEVELS)
    ref = jax.jit(lambda c, v: jax_unet.build_unet_plan_batched(
        c, v, jax_spv.NUM_LEVELS, capacities=caps,
        sample_domains=None if doms is None else np.asarray(doms)))(
        jnp.asarray(coords), jnp.asarray(valid))
    port = port_unet.build_unet_plan_batched(
        torch.from_numpy(coords), torch.from_numpy(valid),
        jax_spv.NUM_LEVELS, capacities=caps, sample_domains=doms)
    return ref, port


# ----- single ops ---------------------------------------------------------

def _scan_with_ties(rng, n=3000):
    """A LiDAR-like scan (N, 4) whose last 200 points repeat earlier ones
    (the same pixel at the same range: ties for the nearest-wins writes)."""
    pts = np.concatenate([rng.uniform(-40, 40, (n, 2)),
                          rng.uniform(-3, 1, (n, 1)),
                          rng.uniform(0, 1, (n, 1))], 1).astype(np.float32)
    pts[-200:] = pts[:200]
    return pts


@pytest.mark.parametrize("cols", [3, 4])
def test_build_range_input_byte_equal(cols):
    pts = _scan_with_ties(np.random.default_rng(cols))[:, :cols]
    got = augmentation_3d.build_range_input(pts, 0.05235, -0.43633, 1024, 64)
    want = jax_aug.build_range_input(pts, 0.05235, -0.43633, 1024, 64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert (got[0][..., 0] > 0).sum() > 1000


def test_dense_depth_label_byte_equal():
    rng = np.random.default_rng(8)
    pts = _scan_with_ties(rng)
    idx = np.stack([rng.integers(0, 30, len(pts)),
                    rng.integers(0, 40, len(pts))], 1)
    idx[-200:] = idx[:200]
    got = depth_label.dense_depth_label((30, 40), idx, pts)
    want = jax_depth.dense_depth_label((30, 40), idx, pts)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    empty = depth_label.dense_depth_label((3, 4), idx[:0], pts[:0])
    assert empty.shape == (3, 4, 1) and not empty.any()


@pytest.mark.parametrize("h,w", [(16, 64), (13, 50), (7, 4), (1, 1)])
def test_avg_pool_same_matches_flax(h, w):
    """flax's "SAME" pads (0, 1) on an even side and (1, 1) on an odd one
    and counts the padding; a symmetric torch padding would shift the
    windows."""
    x = np.random.default_rng(h * w).normal(size=(2, h, w, 3)).astype(
        np.float32)
    want = fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                        padding="SAME")
    got = port_salsa.avg_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-6)


def test_pixel_shuffle_order_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 12)).astype(
        np.float32)
    want = jax_salsa.pixel_shuffle(jnp.asarray(x), 2)
    got = F.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_point_maps_and_pooling_match_jax():
    rng = np.random.default_rng(3)
    coords = rng.integers(0, 20, size=(2, 300, 3)).astype(np.int32)
    valid = np.ones((2, 300), bool)
    valid[1, 200:] = False
    ref, port = _plans(coords, valid)
    want_maps = jax_spv.compose_point_maps(ref)
    got_maps = port_spv.compose_point_maps(port)
    feats = rng.normal(size=(600, 5)).astype(np.float32)
    for l, (g, w) in enumerate(zip(got_maps, want_maps)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=l)
        cap = port.levels[l].valid.shape[0]
        pooled = port_spv.point_to_voxel(torch.from_numpy(feats), g, cap)
        _close(pooled.numpy(), jax_spv.point_to_voxel(
            jnp.asarray(feats), w, cap), 1e-5)
        vf = rng.normal(size=(cap, 5)).astype(np.float32)
        np.testing.assert_array_equal(
            port_spv.voxel_to_point(torch.from_numpy(vf), g).numpy(),
            np.asarray(jax_spv.voxel_to_point(jnp.asarray(vf), w)))


# ----- SPVCNN ---------------------------------------------------------------

@pytest.fixture(scope="module")
def spvcnn_case():
    rng = np.random.default_rng(5)
    coords = rng.integers(0, 24, size=(2, 320, 3)).astype(np.int32)
    valid = np.ones((2, 320), bool)
    valid[1, 250:] = False
    # one BN domain per scan (eval ignores them)
    ref, port = _plans(coords, valid, [0, 1])
    feats = rng.normal(size=(640, 4)).astype(np.float32)
    model = jax_spv.SPVCNN(in_channels=4, cs=TINY_CS, dropout=0.0)
    variables = jax.jit(lambda f: model.init(jax.random.PRNGKey(2), f, ref))(
        jnp.asarray(feats))
    return dict(model=model, variables=variables, ref=ref, port=port,
                feats=feats)


def _port_spvcnn(case, stats=None):
    net = port_spv.SPVCNN(4, TINY_CS, dropout=0.0)
    _load(net, case["variables"], stats)
    return net


def test_spvcnn_eval_forward(spvcnn_case):
    c = spvcnn_case
    stats = perturbed_stats(c["variables"]["batch_stats"], 6)
    want = jax.jit(lambda f: c["model"].apply(
        {"params": c["variables"]["params"], "batch_stats": nest(stats)},
        f, c["ref"]))(jnp.asarray(c["feats"]))
    net = _port_spvcnn(c, stats).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(c["feats"]), c["port"])
    assert got.shape == (640, TINY_CS[8]) and got.dtype == torch.float32
    _close(got.numpy(), want)
    # padding points map to no voxel: their features are the point branch's
    assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("cs", [TINY_CS, port_spv.DEFAULT_CS],
                         ids=["tiny", "default"])
def test_chip_smoke_spvcnn_shapes_are_the_forwards(spvcnn_case, cs,
                                                   monkeypatch):
    """``chip_smoke.spvcnn_conv_shapes`` (the shapes its phase 13 holds K1 /
    K2 to their twins at) lists exactly the (plan level, Cin, Cout) of the
    submanifold convs an SPVCNN forward runs."""
    import chip_smoke

    c = spvcnn_case
    levels = c["port"].levels
    seen = set()

    def spy(x, lv, w):
        seen.add(([i for i, l in enumerate(levels) if l is lv][0],
                  w.shape[1], w.shape[2]))
        return x.new_zeros((x.shape[0], w.shape[2]))

    monkeypatch.setattr(port_spv, "apply_submanifold", spy)
    with torch.no_grad():
        port_spv.SPVCNN(4, cs, dropout=0.0)(torch.from_numpy(c["feats"]),
                                            c["port"])
    assert seen == {s[1:] for s in chip_smoke.spvcnn_conv_shapes(cs)}


def test_spvcnn_train_forward_stats_and_grads(spvcnn_case):
    """Training mode over two BN domains (one per scan): outputs, the new
    running statistics and every parameter's gradient of a weighted sum of
    the valid points' outputs. (A padding point's pre-activation in the
    point branch is exactly 0, where ``jnp.maximum``'s gradient is 1/2 and
    ``torch.relu``'s 0; no loss of the step reads a padding point.)"""
    c = spvcnn_case
    rng = np.random.default_rng(7)
    ref, port = c["ref"], c["port"]
    cot = rng.normal(size=(640, TINY_CS[8])).astype(np.float32)
    cot[port.point_inverse.numpy() < 0] = 0.0

    def loss(params, feats):
        out, mut = c["model"].apply(
            {"params": params,
             "batch_stats": c["variables"]["batch_stats"]}, feats, ref,
            train=True, n_domains=2, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut["batch_stats"])

    (_, (want, want_stats)), (g_params, g_feats) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        c["variables"]["params"], jnp.asarray(c["feats"]))
    net = _port_spvcnn(c).train()
    feats = torch.from_numpy(c["feats"]).requires_grad_(True)
    got = net(feats, port, n_domains=2)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach().numpy(), want)
    got_stats = weights.to_flax(net, dict(net.named_buffers()))
    for k, v in flatten_pytree(want_stats).items():
        _close(got_stats[k], v)
    _grads_close(net, g_params, zero=tuple(
        "point_transform{}.bias".format(i) for i in range(3)))
    _close(feats.grad.numpy(), g_feats)


# ----- SalsaNext --------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(16, 64), (13, 50)])
def test_salsanext_forward_stats_and_grads(h, w, monkeypatch):
    """Eval forward with perturbed statistics, and a training forward's
    output and running statistics (flax's biased fast variance), in
    float32; the training forward's gradients in float64 on both sides.

    Why float64: at 16 x 64 the bottleneck is 1 x 4, where the 2x2 conv of
    dilation 2 sees only padding rows, so a channel holds one constant and
    its batch norm has a true variance of 0. flax's float32 E[x^2] - E[x]^2
    then leaves rounding noise that 1 / sqrt(eps) amplifies into the
    gradients upstream (9 % of a tensor's largest gradient against a float64
    reference, where the port's float32 stays within 4e-5). SalsaNext's
    dropout has no rate option in flax: ``nn.Dropout`` is patched to the
    identity there, and the port's rates are set to 0."""
    monkeypatch.setattr(fnn, "Dropout", _identity_dropout)
    rng = np.random.default_rng(h)
    x = rng.normal(size=(2, h, w, 5)).astype(np.float32)
    model = jax_salsa.SalsaNext(in_channels=5, base=8)
    variables = jax.jit(lambda a: model.init(jax.random.PRNGKey(0), a))(
        jnp.asarray(x))
    stats = perturbed_stats(variables["batch_stats"], h + 1)
    want = jax.jit(lambda a: model.apply(
        {"params": variables["params"], "batch_stats": nest(stats)}, a))(
        jnp.asarray(x))
    net = port_salsa.SalsaNext(5, 8)
    _load(net, variables, stats)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
    assert got.shape == (2, h, w, 8)
    _close(got.numpy(), want)

    cot = rng.normal(size=(2, h, w, 8))

    def train_apply(params, stats_, a):
        out, mut = model.apply({"params": params, "batch_stats": stats_}, a,
                               train=True, mutable=["batch_stats"])
        return out, mut["batch_stats"]

    want, want_stats = jax.jit(train_apply)(
        variables["params"], variables["batch_stats"], jnp.asarray(x))
    net = port_salsa.SalsaNext(5, 8)
    _load(net, variables)
    for mod in net.modules():
        if hasattr(mod, "dropout_rate"):
            mod.dropout_rate = 0.0
    with torch.no_grad():
        got = net.train()(torch.from_numpy(x))
    _close(got.numpy(), want)
    got_stats = weights.to_flax(net, dict(net.named_buffers()))
    for k, v in flatten_pytree(want_stats).items():
        _close(got_stats[k], v)

    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)

        def loss(params):
            out, _ = train_apply(params, f64["batch_stats"],
                                 jnp.asarray(x, jnp.float64))
            return jnp.sum(out.astype(jnp.float64) * cot)

        grads = jax.jit(jax.grad(loss))(f64["params"])
        grads = jax.tree_util.tree_map(np.asarray, grads)
    net = port_salsa.SalsaNext(5, 8, compute_dtype=torch.float64)
    _load(net, variables)
    for mod in net.modules():
        if hasattr(mod, "dropout_rate"):
            mod.dropout_rate = 0.0
    net = net.double().train()
    out = net(torch.from_numpy(x).double())
    (out.double() * torch.from_numpy(cot)).sum().backward()
    _grads_close(net, grads)


# ----- the depth head ----------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_depth_head(train):
    """``InitialTaskPredictionModule`` on 64-channel features: eval with
    perturbed statistics, or training over two BN domains (its statistics
    and gradients too)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 10, 14, 64)).astype(np.float32)
    model = jax_r34.InitialTaskPredictionModule(n_domains=2)
    variables = jax.jit(lambda a: model.init(jax.random.PRNGKey(4), a,
                                             train=False))(jnp.asarray(x))
    head = port_r34.InitialTaskPredictionModule()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if not train:
        stats = perturbed_stats(variables["batch_stats"], 12)
        want = model.apply({"params": variables["params"],
                            "batch_stats": nest(stats)}, jnp.asarray(x),
                           train=False)
        _load(head, variables, stats)
        with torch.no_grad():
            got = head.eval()(xt, 2)
        _close(got.permute(0, 2, 3, 1).numpy(), want)
        return
    cot = rng.normal(size=(4, 10, 14, 1)).astype(np.float32)

    def loss(params):
        out, mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut["batch_stats"])

    (_, (want, want_stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["params"])
    _load(head, variables)
    got = head.train()(xt, 2).permute(0, 2, 3, 1)
    assert got.dtype == torch.float32 and got.shape == (4, 10, 14, 1)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach().numpy(), want)
    got_stats = weights.to_flax(head, dict(head.named_buffers()))
    for k, v in flatten_pytree(want_stats).items():
        _close(got_stats[k], v)
    _grads_close(head, grads)


def test_unet_with_depth_head_returns_both_maps():
    """UNetResNet34(depth_pred) at an unpadded size: the features and the
    depth map (read from the cropped features) against JAX's."""
    rng = np.random.default_rng(13)
    img = rng.uniform(0, 1, (2, 30, 44, 3)).astype(np.float32)
    model = jax_r34.UNetResNet34(pretrained=False, depth_pred=True)
    variables = jax.jit(lambda a: model.init(jax.random.PRNGKey(0), a))(
        jnp.asarray(img))
    stats = perturbed_stats(variables["batch_stats"], 14)
    want_x, want_d = jax.jit(lambda a: model.apply(
        {"params": variables["params"], "batch_stats": nest(stats)}, a))(
        jnp.asarray(img))
    net = port_r34.UNetResNet34(depth_pred=True)
    _load(net, variables, stats)
    with torch.no_grad():
        got_x, got_d = net.eval()(torch.from_numpy(img))
    assert got_d.shape == (2, 30, 44, 1)
    _close(got_x.numpy(), want_x)
    _close(got_d.numpy(), want_d)
